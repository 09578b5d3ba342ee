"""The samplers a traffic mix names (``"sampler"`` in
``lfit_bench/traffic/<traffic>.json``), each a module of its own, found by
that name: ``lfit_bench/samplers/<sampler>.py``."""
