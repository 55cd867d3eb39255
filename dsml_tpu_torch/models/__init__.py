"""Model families of the port: GPT-2 and Llama (serving and training), the
MNIST MLP and CNN (BASELINE config 3) and the CIFAR-10 ResNet-18 (BASELINE
config 4)."""

from dsml_tpu_torch.models.cnn import CNN
from dsml_tpu_torch.models.mlp import MLP
from dsml_tpu_torch.models.resnet import ResNet18

__all__ = ["CNN", "MLP", "ResNet18", "model_by_family"]


def model_by_family(family: str, name: str, device=None, **tiny_kwargs):
    """(model, config) for a family + preset — the one dispatch point the
    entry points share. ``tiny_kwargs`` reach only the ``tiny`` preset. The
    model's weights are allocated on ``device`` (``None`` = the CUDA card)
    and still need ``init(seed)`` or ``load_state_dict``."""
    if family == "llama":
        from dsml_tpu_torch.models.llama import Llama, LlamaConfig

        cfg = LlamaConfig.by_name(name, **tiny_kwargs)
        return Llama(cfg, device=device), cfg
    if family == "gpt2":
        from dsml_tpu_torch.models.gpt2 import GPT2, GPT2Config

        cfg = GPT2Config.by_name(name, **tiny_kwargs)
        return GPT2(cfg, device=device), cfg
    raise ValueError(f"unknown family {family!r}; choose gpt2 | llama")
