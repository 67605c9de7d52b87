from deneva_tpu_torch.workloads.base import QueryPool, WorkloadPlugin
from deneva_tpu_torch.workloads import ycsb


def get(cfg) -> WorkloadPlugin:
    """Workload registry (the reference's WORKLOAD switch, config.h:40).
    The port carries YCSB only so far."""
    from deneva_tpu_torch.config import YCSB

    if cfg.workload == YCSB:
        return ycsb.YCSBWorkload()
    raise NotImplementedError(
        f"workload {cfg.workload!r} is not ported yet (YCSB only)")


__all__ = ["QueryPool", "WorkloadPlugin", "ycsb", "get"]
