"""Model families of the port: GPT-2 (serving and training) and the MNIST
MLP. The other families of ``dsml_tpu.models`` (Llama, the CNN and ResNet)
come with later slices."""

from dsml_tpu_torch.models.mlp import MLP

__all__ = ["MLP", "model_by_family"]


def model_by_family(family: str, name: str, device=None, **tiny_kwargs):
    """(model, config) for a family + preset — the one dispatch point the
    entry points share. ``tiny_kwargs`` reach only the ``tiny`` preset. The
    model's weights are allocated on ``device`` (``None`` = the CUDA card)
    and still need ``init(seed)`` or ``load_state_dict``."""
    if family == "llama":
        raise NotImplementedError("the llama family is not yet ported (see ROADMAP.md)")
    if family == "gpt2":
        from dsml_tpu_torch.models.gpt2 import GPT2, GPT2Config

        cfg = GPT2Config.by_name(name, **tiny_kwargs)
        return GPT2(cfg, device=device), cfg
    raise ValueError(f"unknown family {family!r}; choose gpt2 | llama")
