"""Host-side utilities of the port: the input-file reader, chain files
and sampler checkpoints."""
