"""CC-algorithm registry (the reference's CC_ALG compile switch).  The
port carries NO_WAIT, WAIT_DIE, TIMESTAMP, MVCC, CALVIN, OCC and MAAT."""

from deneva_tpu_torch.cc.base import AccessDecision, CCPlugin
from deneva_tpu_torch.cc.calvin import Calvin
from deneva_tpu_torch.cc.maat import Maat
from deneva_tpu_torch.cc.mvcc import Mvcc
from deneva_tpu_torch.cc.no_wait import NoWait, WaitDie
from deneva_tpu_torch.cc.occ import Occ
from deneva_tpu_torch.cc.timestamp import Timestamp

REGISTRY: dict[str, CCPlugin] = {}


def register(plugin: CCPlugin) -> CCPlugin:
    REGISTRY[plugin.name] = plugin
    return plugin


register(NoWait())
register(WaitDie())
register(Timestamp())
register(Mvcc())
register(Calvin())
register(Occ())
register(Maat())


def get(name: str) -> CCPlugin:
    if name not in REGISTRY:
        raise KeyError(f"CC algorithm {name!r} not registered "
                       f"(have: {sorted(REGISTRY)})")
    return REGISTRY[name]


__all__ = ["AccessDecision", "CCPlugin", "REGISTRY", "register", "get"]
