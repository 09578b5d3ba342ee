"""Post-processing of a fit: the white-dwarf atmosphere fit
(``post.wdparams``)."""
