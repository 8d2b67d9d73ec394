"""Device mesh construction and k-mer table sharding.

The reference's only parallelism is a shared-memory thread pool over
windows with one shared in-RAM KMC table (Plugins/GetVariants.java:
129-159, Data/KMC.java:69-75). The device-mesh equivalents:

* ``data`` axis: window batches are sharded across devices (the analog
  of the thread pool) - pure data parallelism, no communication beyond
  the host gather of per-window scalars.
* ``table`` axis: for k-mer tables larger than one device's memory,
  buckets are sharded across devices; queries are all-gathered over the
  table axis and per-shard partial counts are reduce-scattered back (a
  k-mer's bucket lives on exactly one shard, so the sum over shards is
  exact).

The mesh is a plain (data, table) reshape of the device list. Multi-host:
``init_distributed`` wraps jax.distributed; the same mesh code spans
hosts.
"""

import numpy as np
from .. import jaxinit  # noqa: F401  (x64 + compile cache, before jax use)
import jax
from jax.sharding import Mesh

from ..utils.logger import Logger

_CLASS = "Mesh"


def init_distributed(coordinator=None, num_processes=None, process_id=None):
    """Multi-host init (no-op when single-process)."""
    if num_processes and num_processes > 1:
        jax.distributed.initialize(coordinator, num_processes, process_id)


def make_mesh(data: int = None, table: int = 1, devices=None) -> Mesh:
    """2D mesh over (data, table). Defaults: all devices on data axis.

    Under jax.distributed with table > 1, devices are arranged so the
    TABLE axis partitions the processes: each host then stores a
    disjoint slice of the k-mer table (table_bytes / n_hosts at peak -
    the wheat-scale requirement) and the streaming loader stages only
    local shards; the table-axis psum crosses hosts while the data axis
    stays host-local."""
    if devices is None:
        devices = jax.devices()
        n_proc = jax.process_count()
        if data is None:
            data = len(devices) // table
        if (
            n_proc > 1
            and table % n_proc == 0
            and data * table == len(devices)
            and len(devices) % n_proc == 0
        ):
            devs = sorted(devices, key=lambda d: (d.process_index, d.id))
            per = len(devices) // n_proc  # devices per process
            cols_pp = table // n_proc  # table columns per process
            arr = np.empty((data, table), dtype=object)
            for p in range(n_proc):
                block = np.array(
                    devs[p * per : (p + 1) * per], dtype=object
                ).reshape(data, cols_pp)
                arr[:, p * cols_pp : (p + 1) * cols_pp] = block
            return Mesh(arr, ("data", "table"))
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if data is None:
        data = n // table
    if data * table != n:
        Logger.error(_CLASS, f"mesh {data}x{table} != {n} devices")
    return Mesh(devices.reshape(data, table), ("data", "table"))
