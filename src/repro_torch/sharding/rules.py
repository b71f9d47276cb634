"""CV batch rules for the sharded serve (the counterpart of the ``cv_*``
helpers of `repro.sharding.rules`).

The CV serving path shards one thing: the image-batch axis of a bucket
batch, and of everything the pipeline derives from it (descriptors,
validity masks and predictions all keep the batch axis leading).  Shards
are contiguous slices of that axis.  JAX's `cv_batch_spec`,
`cv_batch_sharding` and `cv_out_specs` build `PartitionSpec` and
`NamedSharding` layouts for `shard_map`, which have no PyTorch meaning:
the port's dispatcher places each slice on its device itself, so they are
not ported.  The LM stack's rules come with ROADMAP Queue 1 item 8, step 9.
"""

from __future__ import annotations

import numpy as np


def cv_data_devices(mesh) -> list:
    """The devices along the mesh's "data" axis: the fault domains of the
    sharded CV dispatch, in shard order."""
    if "data" not in mesh.axis_names:
        raise ValueError(
            f"cv_data_devices: mesh has no 'data' axis (axes: "
            f"{mesh.axis_names}) — build one with launch.mesh.make_cv_mesh")
    return list(mesh.devices)


def cv_batch_split(batch: np.ndarray, n: int) -> tuple[list, int]:
    """Split a batch into `n` contiguous shards of equal size -> (shards,
    rows a shard).  The last row is repeated until the batch divides `n`;
    those padding rows are dropped again on merge."""
    pad = (-batch.shape[0]) % n
    if pad:
        batch = np.concatenate([batch, batch[-1:].repeat(pad, axis=0)])
    per = batch.shape[0] // n
    return [batch[i * per:(i + 1) * per] for i in range(n)], per
