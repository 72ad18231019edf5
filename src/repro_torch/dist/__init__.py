"""Lane balance, lane blocks, sharding plans, tensor parallelism and
fault handling.

:mod:`~repro_torch.dist.plan` is the port of the JAX package's
``dist/plan.py``: the plan-time partitioner of chunk lanes and the lane
blocks of a mesh decode (numpy), and the model's sharding plan
(``rules_for``, ``param_rules``, ``ShardLayout``).
:mod:`~repro_torch.dist.sharding` holds the logical-axis rules;
:mod:`~repro_torch.dist.tensor_parallel` the model group's collectives,
the vocab-parallel embedding and logits; :mod:`~repro_torch.dist.fault`
times train steps and flags stragglers.
"""
from . import plan  # noqa: F401
