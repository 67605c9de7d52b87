from deneva_tpu_torch.workloads.base import QueryPool, WorkloadPlugin
from deneva_tpu_torch.workloads import ycsb


def get(cfg) -> WorkloadPlugin:
    """Workload registry (the reference's WORKLOAD switch, config.h:40).
    The port carries YCSB and TPC-C so far."""
    from deneva_tpu_torch.config import TPCC, YCSB

    if cfg.workload == YCSB:
        return ycsb.YCSBWorkload()
    if cfg.workload == TPCC:
        from deneva_tpu_torch.workloads.tpcc import TPCCWorkload
        return TPCCWorkload()
    raise NotImplementedError(
        f"workload {cfg.workload!r} is not ported yet (YCSB and TPCC only)")


__all__ = ["QueryPool", "WorkloadPlugin", "ycsb", "get"]
