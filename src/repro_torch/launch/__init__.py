"""Launch: the multi-process decode over a ``torch.distributed`` store
(:mod:`~repro_torch.launch.multihost`)."""
