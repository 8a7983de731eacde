"""Datasets: the static, temporal and dynamic base classes, Cora, Pubmed, the
OGB node-property loader, the six static-temporal loaders (WikiMath,
WindmillOutput, HungaryCP, PedalMe, MontevideoBus, METR-LA) and
England-COVID. Loaders are host numpy; models move data to their device."""

from stgraph_tpu_torch.dataset.base import (
    STGraphDataset,
    STGraphDynamicDataset,
    STGraphStaticDataset,
    STGraphTemporalDataset,
)
from stgraph_tpu_torch.dataset.cora_dataloader import CoraDataLoader
from stgraph_tpu_torch.dataset.england_covid_dataloader import EnglandCovidDataLoader
from stgraph_tpu_torch.dataset.hungarycp_dataloader import HungaryCPDataLoader
from stgraph_tpu_torch.dataset.metrla_dataloader import METRLADataLoader
from stgraph_tpu_torch.dataset.montevideobus_dataloader import MontevideoBusDataLoader
from stgraph_tpu_torch.dataset.ogb_dataloader import OGBN_PRODUCTS_STATS, OgbNodeDataLoader
from stgraph_tpu_torch.dataset.pedalme_dataloader import PedalMeDataLoader
from stgraph_tpu_torch.dataset.pubmed_dataloader import PubmedDataLoader
from stgraph_tpu_torch.dataset.wikimath_dataloader import WikiMathDataLoader
from stgraph_tpu_torch.dataset.windmilloutput_dataloader import WindmillOutputDataLoader

__all__ = [
    "CoraDataLoader",
    "EnglandCovidDataLoader",
    "HungaryCPDataLoader",
    "METRLADataLoader",
    "MontevideoBusDataLoader",
    "OGBN_PRODUCTS_STATS",
    "OgbNodeDataLoader",
    "PedalMeDataLoader",
    "PubmedDataLoader",
    "STGraphDataset",
    "STGraphDynamicDataset",
    "STGraphStaticDataset",
    "STGraphTemporalDataset",
    "WikiMathDataLoader",
    "WindmillOutputDataLoader",
]
