"""The mesh split into blocks, stepped in one process or across
processes (`torch.distributed`, one rank per card).

The port of the JAX package's `parallel/`: cells are partitioned into
contiguous blocks after a Morton reordering, each block gets a local
submesh of owned + 2-deep-halo entities (the MPAS block structure,
reference Registry.xml:337-340 config_num_halos=2), and the halos are
refreshed inside the step, the blocks advancing in lockstep; across
ranks the halo transport is `comm.py`'s.
"""

from .partition import Partition, partition_mesh  # noqa: F401
from .sharded import ShardedSeaIceModel  # noqa: F401
