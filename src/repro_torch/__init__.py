"""PyTorch + CUDA port of the ``repro`` train/serve system for NVIDIA Hopper.

The package mirrors ``repro``'s module paths (``configs``, ``models``,
``core``, ``kernels``, ``train``, ``launch``) so every function has an
obvious counterpart in the JAX reference.  It imports ``torch`` and numpy
only: nothing of ``jax`` and nothing of ``repro``; what it needs from the
reference it carries as its own copy.

Entry points run on the GPU (``device="cuda"``) unless the caller asks for
the CPU; with no GPU present and no explicit CPU request they raise.
Paths the port does not run yet raise :func:`not_ported`, naming the
ROADMAP.md item that will port them.
"""


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md {item})"
    )
