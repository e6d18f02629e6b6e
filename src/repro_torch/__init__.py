"""PyTorch + CUDA port of the ``repro`` train/serve system for NVIDIA Hopper.

The package mirrors ``repro``'s module paths (``configs``, ``models``,
``core``, ``kernels``, ``train``, ``launch``) so every function has an
obvious counterpart in the JAX reference.  It imports ``torch`` and numpy
only: nothing of ``jax`` and nothing of ``repro``; what it needs from the
reference it carries as its own copy.

Entry points run on the GPU (``device="cuda"``) unless the caller asks for
the CPU; with no GPU present and no explicit CPU request they raise.
Paths the port does not run yet raise :func:`not_ported`, naming the
ROADMAP.md item that will port them; paths the reference itself cannot
run raise it naming item C5, where there is nothing to port.
"""

REFERENCE_FAILS = "C5"  # ROADMAP.md: paths the reference cannot run


def not_ported(what: str, item: str) -> NotImplementedError:
    if item == REFERENCE_FAILS:
        return NotImplementedError(
            f"{what} does not run in the reference either, so repro_torch "
            f"has nothing to port there (ROADMAP.md {item})")
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md {item})"
    )
