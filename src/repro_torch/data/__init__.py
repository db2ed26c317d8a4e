from repro_torch.data.covertype import COVERTYPE_COLUMNS, generate_covertype
from repro_torch.data.dgp import DGP_NAMES, DGPS, generate
from repro_torch.data.equity import generate_equity_returns
from repro_torch.data.pipeline import CoresetSelector, ShardedLoader, WeightedSubset, subset_loader
from repro_torch.data.synthetic_lm import TokenStreamConfig, sample_batch, sample_modality_stub

__all__ = ["DGPS", "DGP_NAMES", "generate", "generate_covertype", "COVERTYPE_COLUMNS",
           "generate_equity_returns", "CoresetSelector", "ShardedLoader", "WeightedSubset",
           "subset_loader", "TokenStreamConfig", "sample_batch", "sample_modality_stub"]
