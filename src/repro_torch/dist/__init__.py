"""Lane balance: the plan-time partitioner of chunk lanes (numpy).

:mod:`~repro_torch.dist.plan` is the lane-balance half of the JAX
package's ``dist/plan.py``; its logical sharding rules have no
counterpart here.
"""
from . import plan  # noqa: F401
