"""Visit-level fan-out across hosts (imsim_tpu/parallel/multihost.py
counterpart).

Hosts coordinate only on WHO renders WHAT: there is no cross-host
reduction in a visit.  Each host renders its share of a visit's CCDs
(the output.njobs / output.job split, the galsim CLI's -n/-j), on its
own cards through the runner's paths; a visit list strides over hosts
before CCDs.

Topology, in priority order:

1. explicit num_hosts and host_id (a lone one of them raises: it would
   fall back to one host and duplicate work across the fleet);
2. a `coordinator` ("host:port") ->
   torch.distributed.init_process_group(init_method="tcp://<coordinator>")
   with num_hosts and host_id as world size and rank when given, else
   torchrun's environment;
3. an initialized torch.distributed group: hosts = world_size //
   LOCAL_WORLD_SIZE, this host = rank // LOCAL_WORLD_SIZE (torchrun's
   variables);
4. the scheduler's environment: IMSIM_TPU_NUM_HOSTS / IMSIM_TPU_HOST_ID,
   then SLURM_NTASKS / SLURM_PROCID.
"""
from __future__ import annotations

import os


def _group_topology():
    import torch.distributed as dist

    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return dist.get_world_size() // local, dist.get_rank() // local


def detect_topology(coordinator: str | None = None,
                    num_hosts: int | None = None,
                    host_id: int | None = None):
    """Return (num_hosts, host_id)."""
    import torch.distributed as dist

    if (num_hosts is None) != (host_id is None) and not coordinator:
        raise ValueError(
            "detect_topology: pass BOTH num_hosts and host_id (or a "
            "coordinator); a lone value would silently fall back to "
            "single-host and duplicate work across the fleet")
    if num_hosts is not None and host_id is not None:
        return int(num_hosts), int(host_id)
    if coordinator:
        from .mesh import TIMEOUT

        kw = {} if num_hosts is None else dict(world_size=int(num_hosts),
                                               rank=int(host_id))
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                timeout=TIMEOUT, **kw)
        return _group_topology()
    if dist.is_initialized() and dist.get_world_size() > 1:
        return _group_topology()
    for n_var, i_var in (("IMSIM_TPU_NUM_HOSTS", "IMSIM_TPU_HOST_ID"),
                         ("SLURM_NTASKS", "SLURM_PROCID")):
        n = os.environ.get(n_var)
        if n and int(n) > 1:
            return int(n), int(os.environ.get(i_var, 0))
    return 1, 0


def host_share(items, num_hosts: int, host_id: int):
    """Strided split (the galsim CLI's -n/-j semantics, which the
    in-config output.njobs/job path also uses): host j of n takes every
    n-th item starting at j."""
    return list(items)[host_id::num_hosts]


def run_visit_multihost(cfg_or_path, overrides=(), logger=None,
                        coordinator: str | None = None,
                        num_hosts: int | None = None,
                        host_id: int | None = None, device="cuda"):
    """Render this host's share of a visit: the detector list (after
    output.only_dets / output.det_num) strides across hosts through
    output.njobs/job, so the mesh, the pipelined IO and the process info
    all apply per host.  Returns the per-CCD results of THIS host."""
    from ..config.runner import run_visit_iter

    n, j = detect_topology(coordinator, num_hosts, host_id)
    if logger:
        logger.info("multihost: host %d/%d", j, n)
    ov = list(overrides) + [f"output.njobs={n}", f"output.job={j + 1}"]
    return list(run_visit_iter(cfg_or_path, overrides=ov, device=device,
                               logger=logger))


def run_visits_multihost(cfg_or_path, visits, overrides=(), logger=None,
                         coordinator: str | None = None,
                         num_hosts: int | None = None,
                         host_id: int | None = None, device="cuda"):
    """Several visits: visits stride across hosts first (each rendered
    whole by one host, no cross-host traffic), CCDs run on the host's
    cards.  `visits`: visit ids resolved through input.opsim_data.visit.
    Returns {visit: [results]} of this host."""
    from ..config.runner import run_visit_iter

    n, j = detect_topology(coordinator, num_hosts, host_id)
    out = {}
    for visit in host_share(visits, n, j):
        ov = list(overrides) + [f"input.opsim_data.visit={visit}"]
        if logger:
            logger.info("multihost: host %d/%d rendering visit %s",
                        j, n, visit)
        out[visit] = list(run_visit_iter(cfg_or_path, overrides=ov,
                                         device=device, logger=logger))
    return out
