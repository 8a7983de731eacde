"""Datasets: the static and dynamic base classes, Cora, Pubmed, the OGB
node-property loader and England-COVID (the other temporal loaders come
with the temporal slice). Loaders are host numpy; models move data to their
device."""

from stgraph_tpu_torch.dataset.base import STGraphDataset, STGraphDynamicDataset, STGraphStaticDataset
from stgraph_tpu_torch.dataset.cora_dataloader import CoraDataLoader
from stgraph_tpu_torch.dataset.england_covid_dataloader import EnglandCovidDataLoader
from stgraph_tpu_torch.dataset.ogb_dataloader import OGBN_PRODUCTS_STATS, OgbNodeDataLoader
from stgraph_tpu_torch.dataset.pubmed_dataloader import PubmedDataLoader

__all__ = [
    "CoraDataLoader",
    "EnglandCovidDataLoader",
    "OGBN_PRODUCTS_STATS",
    "OgbNodeDataLoader",
    "PubmedDataLoader",
    "STGraphDataset",
    "STGraphDynamicDataset",
    "STGraphStaticDataset",
]
