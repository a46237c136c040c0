"""The one place that picks the DP scoring implementation."""

from __future__ import annotations

IMPLS = ("jnp", "pallas")


def resolve_align_impl(requested: str = "auto", interpret: bool = False
                       ) -> str:
    """'auto' -> 'pallas' (the banded GPU kernel) when JAX's default backend
    is a GPU, 'jnp' (``nw_ref``) otherwise.  An explicit 'pallas' off the
    GPU is an error unless the caller asks for the Pallas interpreter
    (``interpret=True``, the CPU tests): interpret mode is never chosen
    silently."""
    import jax
    backend = jax.default_backend()
    if requested == "auto":
        return "pallas" if backend == "gpu" else "jnp"
    if requested not in IMPLS:
        raise ValueError(f"align_impl must be one of {IMPLS} or 'auto', "
                         f"not {requested!r}")
    if requested == "pallas" and backend != "gpu" and not interpret:
        raise ValueError(
            f"align_impl='pallas' compiles for a GPU and the backend is "
            f"{backend!r}; use 'jnp', or interpret=True to run the kernel "
            f"in the Pallas interpreter")
    return requested
