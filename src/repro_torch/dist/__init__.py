"""Lane balance, lane blocks, logical-axis rules and fault handling.

:mod:`~repro_torch.dist.plan` (numpy, the plan-time partitioner of chunk
lanes and the lane blocks of a mesh decode) is the lane-balance half of
the JAX package's ``dist/plan.py``; :mod:`~repro_torch.dist.sharding` is
the decoder's half of its logical-axis rules (the model sharding plan
waits for ROADMAP A15). :mod:`~repro_torch.dist.fault` times train steps
and flags stragglers.
"""
from . import plan  # noqa: F401
