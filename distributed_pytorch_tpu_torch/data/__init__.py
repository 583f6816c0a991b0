from . import augment, cifar10, pipeline, sampler
from .cifar10 import Dataset, load
from .pipeline import DataLoader
from .sampler import DistributedSampler, ElasticSampler

__all__ = [
    "augment", "cifar10", "pipeline", "sampler",
    "Dataset", "load", "DataLoader", "DistributedSampler",
    "ElasticSampler",
]
