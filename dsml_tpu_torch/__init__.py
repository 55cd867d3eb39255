"""dsml_tpu_torch — the PyTorch and CUDA port of ``dsml_tpu`` for NVIDIA Hopper.

The JAX package ``dsml_tpu`` stays the reference; this package does the same
work in PyTorch, slice by slice, with every Pallas TPU kernel on a ported
path rewritten by hand for ``sm_90a``:

- ``dsml_tpu_torch.ops``    — attention, the flash-attention forward and
  backward kernels (``ops/csrc/flash_fwd.cu``; ``ops/csrc/flash_bwd_tc.cu``
  for bf16 on the tensor cores, ``ops/csrc/flash_bwd.cu`` for f32) behind
  ``ops.flash``, the paged-attention kernels
  (``ops/csrc/paged_attn.cu``) behind ``ops.paged_attention``, the KV-row
  codec (``ops.quantization``) and the chunked cross-entropy
  (``ops.xent``).
- ``dsml_tpu_torch.models`` — GPT-2 serving (prefill, KV-cache decode,
  sampling, ``generate``, the per-slot dense and paged surfaces) and
  training (``loss``), and the MNIST MLP.
- ``dsml_tpu_torch.serving`` — the continuous batcher over a dense or
  paged KV cache, and the page allocator.
- ``dsml_tpu_torch.trainer`` — the single-device epoch trainer.
- ``dsml_tpu_torch.utils``  — config, logging, device selection, data
  iterators, learning-rate schedules and metrics.
- ``dsml_tpu_torch.cli``    — entry points (``cli.generate_text``,
  ``cli.serve_continuous``, ``cli.train_gpt2``).

It imports neither ``jax`` nor anything of ``dsml_tpu``. Entry points run on
the CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

# Lazy subpackage access keeps torch-heavy modules out of the import path
# until used.
_SUBPACKAGES = ("ops", "models", "serving", "utils", "cli")


def __getattr__(name):
    if name in _SUBPACKAGES:
        import importlib

        mod = importlib.import_module(f"{__name__}.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
