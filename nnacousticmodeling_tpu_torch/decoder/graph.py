"""Decoding-image generation from the Kaldi model artifacts.

A copy of the JAX package's ``decoder/graph.py`` (numpy only) on this
package's ``io`` and ``decoder.image``. The reference bundle's files are
named relative to its root (``kaldi/tree``, ``kaldi/final.mdl``,
``recog/phones.60-48-39.map``): ``build_timit_image`` and the CLI take
those paths, by default relative to the current directory, where the
JAX package names one fixed location.

The reference ships a prebuilt ``recog/kaldiTri1909.img`` (missing from
this tree — .MISSING_LARGE_BLOBS) and no generator. This module rebuilds
an image in the exact native format from what *is* checked in:

* ``kaldi/tree``   — triphone-context -> pdf decision tree
* ``kaldi/final.mdl`` — HMM topology + trained transition log-probs
* a phone bigram LM (uniform by default, or estimated from MLFs)

Phone-id convention (standard Kaldi TIMIT s5 lang dir, reconstructed):
id 0 = <eps>; id 1 = ``sil`` (the optional-silence phone — confirmed by
its distinct 0.5/0.5 topology entry in final.mdl); ids 2..48 = the other
47 phones of the 48-set (column 2 of recog/phones.60-48-39.map) sorted.

Graph construction: biphone (a,b) = connection point "phone a just
ended, phone b running"; triphone (a-b+c) spans (a,b) -> (b,c) with 3
emitting states whose pdfs come from the tree and whose self-loop /
forward log-probs come from the trained transition model. Utterance
start/end use sil context: start biphone of phone p is (sil, p), end
biphone is (p, sil) — TIMIT utterances begin and end with silence.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..io.kaldi_mdl import TransitionModel, load_transition_model
from ..io.kaldi_tree import ContextDependency, load_tree
from ..io.phone_map import load_phone_map
from .image import HmmImage, _csr_from_biphone_out

# the reference bundle's files, relative to its root
TREE_FILE = "kaldi/tree"
MDL_FILE = "kaldi/final.mdl"
PHONE_MAP_FILE = "recog/phones.60-48-39.map"


def timit48_phone_names(phone_map_file: str) -> List[str]:
    """Reconstruct phones.txt order: ['sil', <47 others sorted>]."""
    names = sorted({parts[1] for parts in
                    (l.split() for l in open(phone_map_file)) if len(parts) == 3})
    if "sil" not in names:
        raise ValueError("phone map lacks 'sil'")
    names.remove("sil")
    return ["sil"] + names


def build_image(
    tree: ContextDependency,
    tm: TransitionModel,
    phone_names: Sequence[str],
    lm: Optional[np.ndarray] = None,
    sil_id: int = 1,
) -> HmmImage:
    """Build an HmmImage. ``phone_names[i]`` names phone id ``i+1``.

    ``lm`` is a (P, P) matrix of log P(b | a) over phone ids 1..P
    (row a-1, col b-1); uniform ``-log(P)`` if omitted.
    """
    phones = tm.phones                       # [1..P]
    P = len(phones)
    if len(phone_names) != P:
        raise ValueError(f"{len(phone_names)} names for {P} phones")
    if lm is None:
        lm_mat = np.full((P, P), -np.log(P), dtype=np.float32)
    else:
        lm_mat = np.asarray(lm, dtype=np.float32)
        if lm_mat.shape != (P, P):
            raise ValueError(f"lm shape {lm_mat.shape} != ({P},{P})")

    def biphone(a: int, b: int) -> int:      # a, b are 1-based phone ids
        return (a - 1) * P + (b - 1)

    num_biphones = P * P

    biphone_in: List[int] = []
    biphone_out: List[int] = []
    state_idxs: List[List[int]] = []
    tp_self: List[List[float]] = []
    tp_trans: List[List[float]] = []
    names: List[str] = []
    skipped = 0
    for b in phones:
        num_emitting = sum(1 for s in tm.topology[b] if s.pdf_class >= 0)
        if num_emitting != 3:
            raise ValueError(f"phone {b}: expected 3 emitting states")
        for a in phones:
            for c in phones:
                pdfs = []
                ok = True
                for cls in range(3):
                    pdf = tree.map_to_pdf((a, b, c), cls)
                    if pdf is None or (b, cls, pdf) not in tm.triple_index:
                        ok = False
                        break
                    pdfs.append(pdf)
                if not ok:
                    skipped += 1
                    continue
                logps = [tm.state_log_probs(b, s, pdfs[s]) for s in range(3)]
                biphone_in.append(biphone(a, b))
                biphone_out.append(biphone(b, c))
                state_idxs.append(pdfs)
                tp_self.append([lp[0] for lp in logps])
                tp_trans.append([lp[1] for lp in logps])
                names.append(phone_names[b - 1])

    biphone_out_arr = np.asarray(biphone_out, dtype=np.int32)
    out_offsets, out_values = _csr_from_biphone_out(biphone_out_arr, num_biphones)

    lm_flat = lm_mat.reshape(-1).astype(np.float32)   # row a-1, col b-1
    start_idxs = np.asarray([biphone(sil_id, p) for p in phones], dtype=np.int32)
    end_idxs = np.asarray([biphone(p, sil_id) for p in phones], dtype=np.int32)

    return HmmImage(
        num_phones=P,
        num_biphones=num_biphones,
        num_triphones=len(biphone_in),
        num_states=tm.num_pdfs,
        start_idxs=start_idxs,
        end_idxs=end_idxs,
        biphone_in=np.asarray(biphone_in, dtype=np.int32),
        biphone_out=biphone_out_arr,
        state_idxs=np.asarray(state_idxs, dtype=np.int32),
        tp_selfloop=np.asarray(tp_self, dtype=np.float32),
        tp_transition=np.asarray(tp_trans, dtype=np.float32),
        out_offsets=out_offsets,
        out_values=out_values,
        lm=lm_flat,
        phone_names=names,
    )


def cube_phone_names(image) -> List[str]:
    """Per-PHONE names (index = 0-based phone id) of a dense cube image.

    The image's ``phone_names`` are per-triphone; for cube images the
    center phone of triphone 0 of each center-block gives the phone
    name (order detected like ``ViterbiDecoder._detect_cube_order``)."""
    P = image.num_phones
    if image.num_triphones != P ** 3 or image.num_biphones != P * P:
        raise ValueError("not a dense cube image")
    a, b, c = np.meshgrid(np.arange(P), np.arange(P), np.arange(P),
                          indexing="ij")
    for order, (left, center) in (("abc", (a, b)), ("bac", (b, a))):
        if np.array_equal(image.biphone_in, (left * P + center).reshape(-1)):
            stride = P if order == "abc" else P * P
            return [image.phone_names[p * stride] for p in range(P)]
    raise ValueError("unrecognized cube order")


def image_with_bigram_lm(image, lm_mat: np.ndarray):
    """Copy of ``image`` with its per-biphone LM row replaced by the
    (P, P) log P(b|a) matrix (biphone (a, b) = a*P + b, ``build_image``'s
    layout) — lets ``evaluate --lm-from-mlf`` decode with an estimated
    phone bigram instead of the image's stored LM."""
    import dataclasses
    lm_mat = np.asarray(lm_mat, dtype=np.float32)
    if lm_mat.shape != (image.num_phones, image.num_phones):
        raise ValueError(f"lm shape {lm_mat.shape} != "
                         f"({image.num_phones}, {image.num_phones})")
    return dataclasses.replace(image, lm=lm_mat.reshape(-1).copy())


def estimate_bigram_lm(
    mlf_words: Dict[str, List[str]],
    phone_names: Sequence[str],
    phone_map_file: Optional[str] = None,
    add_k: float = 0.5,
) -> np.ndarray:
    """Phone bigram log P(b|a) from transcripts.

    Reference MLFs hold 39-set phones; when ``phone_map_file`` is given,
    48-set phone pairs are counted through their 39-set projections
    (every 48-set phone mapping to the same 39-set class shares the
    statistic). add-k smoothing.
    """
    P = len(phone_names)
    proj = {n: n for n in phone_names}
    if phone_map_file is not None:
        m = load_phone_map(phone_map_file)  # 48 -> 39
        proj = {n: m.get(n, n) for n in phone_names}

    classes = sorted(set(proj.values()))
    cidx = {c: i for i, c in enumerate(classes)}
    counts = np.full((len(classes), len(classes)), add_k, dtype=np.float64)
    for words in mlf_words.values():
        for a, b in zip(words[:-1], words[1:]):
            if a in cidx and b in cidx:
                counts[cidx[a], cidx[b]] += 1.0
    probs = counts / counts.sum(axis=1, keepdims=True)

    lm = np.zeros((P, P), dtype=np.float32)
    for i, a in enumerate(phone_names):
        for j, b in enumerate(phone_names):
            lm[i, j] = np.log(probs[cidx[proj[a]], cidx[proj[b]]])
    return lm


def build_timit_image(
    tree_file: str = TREE_FILE,
    mdl_file: str = MDL_FILE,
    phone_map_file: str = PHONE_MAP_FILE,
    lm: Optional[np.ndarray] = None,
) -> HmmImage:
    """The reference TIMIT setup's image in one call."""
    tree = load_tree(tree_file)
    tm = load_transition_model(mdl_file)
    names = timit48_phone_names(phone_map_file)
    return build_image(tree, tm, names, lm=lm)


def main(arg_list=None):
    """Image-minting CLI — fills the reference's missing-blob gap
    (recog/kaldiTri1909.img is absent from its tree and it ships no
    generator, .MISSING_LARGE_BLOBS:2)::

        python -m nnacousticmodeling_tpu_torch.decoder.graph \
            --out recog/kaldiTri1909.img [--lm-from-mlf train_ref.mlf ...]
    """
    import argparse

    from ..io.mlf import load_mlf
    from .image import save_image

    parser = argparse.ArgumentParser(
        description="Mint a PhoneRecog decoding image from Kaldi artifacts")
    parser.add_argument("--out", required=True,
                        help="output image file (native PhoneRecog format)")
    parser.add_argument("--tree", default=TREE_FILE)
    parser.add_argument("--mdl", default=MDL_FILE)
    parser.add_argument("--phone-map",
                        default=PHONE_MAP_FILE)
    parser.add_argument("--lm-from-mlf", nargs="+", default=None,
                        help="estimate the phone bigram LM from these "
                             "reference MLFs (uniform LM otherwise)")
    parser.add_argument("--lm-add-k", type=float, default=0.5,
                        help="add-k smoothing for the estimated LM")
    args = parser.parse_args(list(map(str, arg_list))
                             if arg_list is not None else None)

    lm = None
    if args.lm_from_mlf:
        names = timit48_phone_names(args.phone_map)
        words = {}
        for f in args.lm_from_mlf:
            words.update({u: e.words for u, e in load_mlf(f).items()})
        lm = estimate_bigram_lm(words, names,
                                phone_map_file=args.phone_map,
                                add_k=args.lm_add_k)
        print(f"bigram LM estimated from {len(words)} transcripts")
    img = build_timit_image(tree_file=args.tree, mdl_file=args.mdl,
                            phone_map_file=args.phone_map, lm=lm)
    from pathlib import Path
    Path(args.out).parent.mkdir(exist_ok=True, parents=True)
    save_image(args.out, img)
    print(f"wrote {args.out}: {img.num_phones} phones, "
          f"{img.num_biphones} biphones, {img.num_triphones} triphones, "
          f"{img.num_states} pdfs")
    return img


if __name__ == "__main__":
    main()
