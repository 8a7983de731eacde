"""Datasets: the OGB node-property loader (the other loaders come with the
temporal slice). Loaders are host numpy; models move data to their device."""

from stgraph_tpu_torch.dataset.ogb_dataloader import OGBN_PRODUCTS_STATS, OgbNodeDataLoader

__all__ = ["OGBN_PRODUCTS_STATS", "OgbNodeDataLoader"]
