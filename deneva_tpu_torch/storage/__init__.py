"""Multi-table storage: catalog-lite + warehouse-striped key encoding (a
copy of ``deneva_tpu/storage/catalog.py``, numpy-free and torch-free), and
the ordered index (``ordered.py``, on torch)."""

from deneva_tpu_torch.storage.catalog import Catalog, Table

__all__ = ["Catalog", "Table"]
