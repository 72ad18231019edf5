"""Lane balance and fault handling.

:mod:`~repro_torch.dist.plan` (numpy, the plan-time partitioner of chunk
lanes) is the lane-balance half of the JAX
package's ``dist/plan.py``; its logical sharding rules have no
counterpart here. :mod:`~repro_torch.dist.fault` times train steps and
flags stragglers.
"""
from . import plan  # noqa: F401
