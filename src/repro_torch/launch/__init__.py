"""Launch: the multi-process decode over a ``torch.distributed`` store
(:mod:`~repro_torch.launch.multihost`), the serving and training launchers
(:mod:`~repro_torch.launch.serve`, :mod:`~repro_torch.launch.train`)."""
