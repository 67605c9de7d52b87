"""Multi-table storage: catalog-lite + warehouse-striped key encoding
(a copy of ``deneva_tpu/storage``; numpy-free and torch-free)."""

from deneva_tpu_torch.storage.catalog import Catalog, Table

__all__ = ["Catalog", "Table"]
