"""PyTorch + CUDA port of ``nnacousticmodeling_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; every module here
mirrors its counterpart's path and names, and its tests hold the two
against each other on the same inputs. This package imports neither
JAX nor the JAX package: it keeps its own copies of the numpy-only
modules.

Subpackages
-----------
io        artifact I/O: .npy corpora, MLF, Kaldi files, phone maps
ops       splice, numerics, time delay, raw-audio features (fbank,
          MFCC, CMN) with the hand-written fbank kernel, and the
          hand-written recurrence kernels of the LSTM, GRU / minimal GRU
          and peephole LSTM (inference; training forward, backward, dW)
models    LSTM, zoneout / peephole LSTM, GRU and MGRU cells and stacks
          as ``nn.Module``s, bf16 compute
train     staged TBPTT engine, optimizers, schedules, stream layout, and
          ``.npz`` checkpoints under the JAX package's keys
infer     bucketed posterior inference
decoder   HMM image I/O, the collapsed and dense-cube Viterbi kernels,
          the scan twins, the backtrace, PER
pipeline  single-model evaluation and training CLIs, the synthetic
          corpus generator

Devices: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without that request they raise.
A kernel wrapper launches its CUDA kernel for a CUDA tensor and uses its
plain PyTorch version only for a CPU tensor.
"""

__version__ = "0.1.0"
