from deneva_tpu_torch.workloads.base import QueryPool, WorkloadPlugin
from deneva_tpu_torch.workloads import ycsb


def get(cfg) -> WorkloadPlugin:
    """Workload registry (the reference's WORKLOAD switch, config.h:40).
    The port carries all three: YCSB, TPC-C and PPS."""
    from deneva_tpu_torch.config import PPS, TPCC, YCSB

    if cfg.workload == YCSB:
        return ycsb.YCSBWorkload()
    if cfg.workload == TPCC:
        from deneva_tpu_torch.workloads.tpcc import TPCCWorkload
        return TPCCWorkload()
    if cfg.workload == PPS:
        from deneva_tpu_torch.workloads.pps import PPSWorkload
        return PPSWorkload()
    raise ValueError(f"unknown workload {cfg.workload!r}")


__all__ = ["QueryPool", "WorkloadPlugin", "ycsb", "get"]
