"""Walker sharding over the ranks of a ``torch.distributed`` process
group (``parallel.mesh``)."""
