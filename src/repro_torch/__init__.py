"""PyTorch / CUDA port of the reproduction in ``repro``.

The package mirrors ``repro``'s layout module for module. It imports
``torch`` and numpy, never jax and nothing of ``repro``. It holds MFBC
(betweenness and the other graph metrics, exact and sampled, on one
device or a mesh of ranks), its serving stack and resumable runs, and
the LM family that serves through ``serve.engine`` and
``launch.serve`` and trains through ``train.train_lib`` and
``launch.train`` (``models``, ``configs``, ``optim``, ``data``). Entry
points default to
``device="cuda"`` and raise on a host without a card; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""
import torch


def resolve_device(device) -> torch.device:
    """The ``torch.device`` to run on; raises when CUDA is asked for and
    absent, instead of carrying on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (on a command line: "
            "--device cpu) to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    return dev
