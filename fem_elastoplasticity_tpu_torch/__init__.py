"""PyTorch/CUDA port of `fem_elastoplasticity_tpu` for one NVIDIA H100.

The JAX package stays the reference; this package imports neither JAX nor
the JAX package.  Each module mirrors its counterpart's path in the JAX
package (`ops/`, `mesh/`, `models/`, `solve/`, `parallel/`, `utils/`,
`benchmarks/`).
"""
