"""Multi-host launch: the process-deployment layer.

The reference deploys as a CORBA executable per host, brokered by the
REDHAWK domain manager (cpp/main.cpp:24-29; omniORB is control-plane only,
SURVEY.md section 5).  Here one process per host drives all of that host's
cards; ``jax.distributed.initialize`` joins the hosts' processes into one
global device mesh, and the data plane is XLA collectives (NVLink within a
host, the network between hosts; parallel/sharded.py).

Typical use on N hosts:

    from psk_soft_tpu.parallel import launch
    launch.initialize()        # PSK_COORDINATOR / PSK_NUM_PROCESSES /
                               # PSK_PROCESS_ID, or pass them explicitly
    mesh = launch.global_mesh(time=launch.num_hosts())
    run = make_sharded_demod(cfg, mesh, total_symbols)

Lay the *time* axis across hosts only when streams are long enough that the
seam halo (numAvg*sps samples) amortizes over the network; the channel
axis is communication-free and is the default host axis.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
from jax.sharding import Mesh

from .mesh import make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with env fallbacks; no-op if single host
    and no coordinator is configured."""
    coordinator_address = coordinator_address or os.environ.get(
        "PSK_COORDINATOR")
    if num_processes is None and "PSK_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PSK_NUM_PROCESSES"])
    if process_id is None and "PSK_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PSK_PROCESS_ID"])
    if coordinator_address is None and num_processes in (None, 1):
        return  # one process drives all of this host's cards
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def num_hosts() -> int:
    return jax.process_count()


def global_mesh(chan: Optional[int] = None, time: int = 1) -> Mesh:
    """Build a (chan, time) mesh over all global devices.

    Defaults to all devices on the channel axis (communication-free).
    """
    n = len(jax.devices())
    if chan is None:
        if n % time:
            raise ValueError(f"{n} devices not divisible by time={time}")
        chan = n // time
    return make_mesh(chan=chan, time=time, devices=jax.devices())
