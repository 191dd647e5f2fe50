"""Multi-host (multi-process) scaffolding: initialization and
process-aware mesh/global-array construction.

The reference has no distributed runtime at all -- its "multi-host" story
is the caller shipping gob bytes (SURVEY.md §2.3).  Here BASELINE.json
config 5 ("1024-bit group params, multi-host sharded ciphertext batches")
maps to the standard JAX SPMD recipe:

  1. every process calls `initialize()` (jax.distributed.initialize under
     the hood) so all hosts join one runtime and `jax.devices()` becomes
     the GLOBAL device list;
  2. `make_global_mesh()` lays those devices out so the batch ('data')
     axis crosses hosts while any intra-host axis stays on one host's
     all-to-all NVLink;
  3. per-host ciphertext batches become one global sharded array via
     `global_ciphertext_from_local` (jax.make_array_from_process_local_data),
     after which every scheme kernel and the giant-step-sharded BSGS in
     parallel/sharded.py run unchanged -- XLA inserts the
     collectives (the pmin first-hit reduction included).

Single-process sessions pass straight through: `make_global_mesh` works
without `initialize()`, so the same code path serves 1 card, 1 host and
N hosts (exercised by __graft_entry__.dryrun_multichip and the 2-process
CPU integration test in tests/test_multihost.py).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """Join the multi-host runtime (jax.distributed.initialize).

    Pass coordinator_address ("host:port" of process 0), num_processes
    and process_id explicitly: nothing on a GPU host tells JAX of a
    cluster.  Must run before any other JAX call in the process."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = list(local_device_ids)
    jax.distributed.initialize(**kwargs)


def process_info() -> Tuple[int, int]:
    """(process_index, process_count) of the current runtime."""
    return jax.process_index(), jax.process_count()


def make_global_mesh(shape: Optional[Tuple[int, ...]] = None,
                     axis_names: Tuple[str, ...] = (DATA_AXIS,)) -> Mesh:
    """Mesh over the GLOBAL device list.

    shape: mesh shape (defaults to all devices on one 'data' axis).  For
    multi-host meshes, devices are laid out host-major (mesh_utils), so
    the FIRST axis crosses hosts and trailing axes stay within a host --
    shard the batch along the first axis."""
    ndev = len(jax.devices())
    if shape is None:
        shape = (ndev,)
    if int(np.prod(shape)) != ndev:
        raise ValueError(f"mesh shape {shape} != {ndev} global devices")
    from jax.experimental import mesh_utils
    devices = mesh_utils.create_device_mesh(shape)
    return Mesh(devices, axis_names)


def data_sharding(mesh: Mesh, ndim: int, batch_axis_pos: int,
                  axis: str = DATA_AXIS) -> NamedSharding:
    spec = [None] * ndim
    spec[batch_axis_pos] = axis
    return NamedSharding(mesh, P(*spec))


def global_array_from_local(mesh: Mesh, local: np.ndarray,
                            batch_axis_pos: int = 0,
                            axis: str = DATA_AXIS) -> jax.Array:
    """Per-process batch shard -> one global sharded array.

    `local` holds THIS process's rows of the global batch (concatenated
    in process order along the batch axis)."""
    sharding = data_sharding(mesh, local.ndim, batch_axis_pos, axis)
    return jax.make_array_from_process_local_data(sharding, local)


def global_ciphertext_from_local(pk, mesh: Mesh, local_ct,
                                 axis: str = DATA_AXIS):
    """Per-process Ciphertext batch -> globally sharded Ciphertext.

    The multi-host analog of mesh.shard_ciphertext: each process encrypts
    its slice of the batch locally (host CSPRNG stays process-local, as
    the reference's caller-side distribution would), then the limb arrays
    are joined into one global array batch-sharded over `axis`."""
    from ..ops.curve import AffinePoint
    from ..scheme import Ciphertext

    if local_ct.level2:
        z = np.asarray(local_ct.data)
        return Ciphertext(
            global_array_from_local(mesh, z, batch_axis_pos=2, axis=axis),
            True)
    x = np.asarray(local_ct.data.x)
    y = np.asarray(local_ct.data.y)
    inf = np.asarray(local_ct.data.inf)
    return Ciphertext(AffinePoint(
        global_array_from_local(mesh, x, batch_axis_pos=1, axis=axis),
        global_array_from_local(mesh, y, batch_axis_pos=1, axis=axis),
        global_array_from_local(mesh, inf, batch_axis_pos=0, axis=axis)),
        False)


def local_values(arr: jax.Array, batch_axis_pos: int = 0) -> np.ndarray:
    """This process's addressable rows of a batch-sharded global array,
    concatenated in batch order (the inverse of global_array_from_local
    for inspection/assertion on each host)."""
    def start(s):
        idx = s.index[batch_axis_pos]
        return idx.start or 0
    shards = sorted(arr.addressable_shards, key=start)
    return np.concatenate([np.asarray(s.data) for s in shards],
                          axis=batch_axis_pos)
