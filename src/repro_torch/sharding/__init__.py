"""Doubly distributed sharding of the LM stack (the port of
``repro.sharding``): the logical-axis rules (``rules``), the blocks of a
leaf on a mesh (``layout``), and the collectives over a process grid's
rows and columns (``collectives``)."""
from .rules import (PartitionSpec, Rules, batch_axes, constrain,
                    default_rules, fsdp_axes, local_shape, logical_to_spec,
                    spec_tree)

__all__ = ["PartitionSpec", "Rules", "batch_axes", "constrain",
           "default_rules", "fsdp_axes", "local_shape", "logical_to_spec",
           "spec_tree"]
