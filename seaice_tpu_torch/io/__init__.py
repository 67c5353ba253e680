"""I/O: MPAS mesh, forcing and state files, checkpoint and restart,
output streams, and their per-block forms (the replacement for the
PIO / stream-manager layer the reference links against; streams defined
in Registry.xml:1851-2248)."""

from .checkpoint import (save_checkpoint, load_checkpoint,  # noqa: F401
                         write_restart_timestamp, read_restart_timestamp)
from .mesh_reader import read_mpas_mesh, write_mpas_mesh  # noqa: F401
from .output import OutputStream  # noqa: F401
from .parallel import (save_sharded_checkpoint,  # noqa: F401
                       load_sharded_checkpoint, assemble_checkpoint,
                       ShardedOutputStream, assemble_history)
from .state_reader import (read_ice_state, write_ice_state,  # noqa: F401
                           init_state_from_file)
