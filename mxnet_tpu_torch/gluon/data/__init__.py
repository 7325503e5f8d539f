"""gluon.data (counterpart of ``mxnet_tpu/gluon/data``): datasets,
samplers, batchify functions, the ``DataLoader`` with its thread and
process workers, and the vision datasets and transforms."""
from .dataset import (Dataset, SimpleDataset, ArrayDataset,
                      RecordFileDataset)
from .sampler import (Sampler, SequentialSampler, RandomSampler, BatchSampler,
                      FilterSampler, IntervalSampler)
from .dataloader import (DataLoader, default_batchify_fn,
                         default_mp_batchify_fn)
from . import batchify
from . import vision
