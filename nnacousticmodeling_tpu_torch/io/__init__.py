from .binio import load_bin, save_bin
from .mlf import load_mlf, write_mlf, MlfEntry
from .kaldi import (
    load_feature_transform,
    apply_feature_transform,
    specialize_transform_center,
    specialize_transform_tiled,
    load_priors_from_counts,
)
from .corpus import RaggedCorpus, load_corpus, load_utt_list
from .phone_map import load_phone_map, map_phones

__all__ = [
    "load_bin",
    "save_bin",
    "load_mlf",
    "write_mlf",
    "MlfEntry",
    "load_feature_transform",
    "apply_feature_transform",
    "specialize_transform_center",
    "specialize_transform_tiled",
    "load_priors_from_counts",
    "RaggedCorpus",
    "load_corpus",
    "load_utt_list",
    "load_phone_map",
    "map_phones",
]
