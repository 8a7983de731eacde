"""Datasets: the static base class, Cora, Pubmed and the OGB node-property loader
(the temporal loaders come with the temporal slice). Loaders are host
numpy; models move data to their device."""

from stgraph_tpu_torch.dataset.base import STGraphDataset, STGraphStaticDataset
from stgraph_tpu_torch.dataset.cora_dataloader import CoraDataLoader
from stgraph_tpu_torch.dataset.ogb_dataloader import OGBN_PRODUCTS_STATS, OgbNodeDataLoader
from stgraph_tpu_torch.dataset.pubmed_dataloader import PubmedDataLoader

__all__ = [
    "CoraDataLoader",
    "OGBN_PRODUCTS_STATS",
    "OgbNodeDataLoader",
    "PubmedDataLoader",
    "STGraphDataset",
    "STGraphStaticDataset",
]
