"""PHiSeg in PyTorch for NVIDIA GPUs: the port of `phiseg_tpu`.

The package mirrors `phiseg_tpu`'s layout (nn/ models/ engine/ data/ ops/
experiments/ cli/) so each module's counterpart is found under the same
name; scripts/ holds the results tools of the repository's scripts/, and
`python -m phiseg_tpu_torch <name>` runs a CLI by the reference script's
name (__main__.py). It imports torch and never jax, flax or optax. The fused residual
cross-entropy, the one Pallas kernel pair of the JAX package, is a CUDA C++
kernel pair here (ops/fused_residual_ce.py, csrc/fused_residual_ce.cu),
built with nvcc for sm_90a at first use.
"""

__version__ = "0.1.0"
