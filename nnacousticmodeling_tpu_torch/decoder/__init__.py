from .score import levenshtein_distance, phone_errors, nist_phone_errors, compute_per
from .image import HmmImage, load_image, save_image, make_synthetic_image
from .viterbi import DecodeResult, ViterbiDecoder
from .viterbi_collapsed import CollapsedViterbi, UnsupportedImage
from .viterbi_cube import CubeViterbi
from .corpus_decode import decode_corpus

__all__ = [
    "levenshtein_distance",
    "phone_errors",
    "nist_phone_errors",
    "compute_per",
    "HmmImage",
    "load_image",
    "save_image",
    "make_synthetic_image",
    "DecodeResult",
    "ViterbiDecoder",
    "CollapsedViterbi",
    "CubeViterbi",
    "UnsupportedImage",
    "decode_corpus",
]
