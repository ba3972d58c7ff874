"""Adjoint memory management: checkpointed time loops for reverse mode.

Counterpart of ``dl_esm_inf_tpu/ops/adjoint.py``.  Reverse-mode
differentiation of an ``n``-step time loop keeps every intermediate of
every step for the backward pass: for the flagship's ~40 temporaries a
step, a production-length assimilation window runs out of device memory
long before it runs out of compute.  Checkpointing (the two-level form
of Griewank's treeverse) trades recomputation for that memory:

* per step (``chunk=1``): the backward pass keeps each step's input
  carry alone and recomputes the step's internals when it reaches it
  (one extra forward evaluation, O(n) carries instead of O(n)
  intermediate sets);
* two levels (``chunk=c > 1``): ``n // c`` checkpointed chunks, each
  running ``c`` per-step checkpoints, then the ``n % c`` remainder steps
  one checkpoint each.  The backward pass keeps the ``n/c`` chunk-entry
  carries and, transiently, the ``c`` step carries of the chunk being
  re-run: O(n/c + c), least at ``c ~ sqrt(n)`` (one more forward pass,
  3x the forward compute in all).

``torch.utils.checkpoint`` in its non-reentrant form does both levels
(nested checkpoints need PyTorch >= 2.1).  Checkpointing changes what
is stored, never what is computed: the forward values, and the
gradients, are bitwise those of the plain loop.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint


def _checkpointed(fn, i: int, state):
    """``fn(i, state)`` as one checkpoint.  The state's tensors go in as
    separate arguments: the checkpoint keeps the tensors among its
    arguments as saved tensors (so a caller's ``saved_tensors_hooks``
    sees what the backward pass keeps), and anything else, a tuple of
    tensors too, by reference.  The steps draw no random numbers, so no
    RNG state is stashed."""
    return checkpoint(lambda i, *s: fn(i, tuple(s)), i, *state,
                      use_reentrant=False, preserve_rng_state=False)


def checkpointed_fori(n: int, body, state, chunk: int | None = 1):
    """``for i in range(n): state = body(i, state)`` with bounded adjoint
    memory.

    ``body`` is ``(i, state) -> state`` with ``i`` the absolute step
    index (a Python int, so time-dependent forcing differentiates as a
    constant); ``state`` is a tuple (tensors, and Python scalars that
    ride along).  ``chunk=None`` is the plain loop, without
    checkpoints; ``chunk <= 1`` gives per-step checkpointing only;
    ``chunk = c > 1`` adds the outer level of the module docstring.
    Without autograd recording (``torch.no_grad``, or no input that
    requires a gradient) every form computes what the plain loop
    does."""
    n = int(n)
    state = tuple(state)
    if chunk is None:
        for i in range(n):
            state = body(i, state)
        return state
    if n <= 0:
        return state
    chunk = max(int(chunk), 1)
    if chunk <= 1 or n <= chunk:
        for i in range(n):
            state = _checkpointed(body, i, state)
        return state
    nchunks, rem = divmod(n, chunk)

    def chunk_body(k, s):
        # per-step checkpoints bound the transient carries of the chunk
        # being re-run in the backward pass
        for j in range(chunk):
            s = _checkpointed(body, k * chunk + j, s)
        return s

    for k in range(nchunks):
        state = _checkpointed(chunk_body, k, state)
    base = nchunks * chunk
    for j in range(rem):
        state = _checkpointed(body, base + j, state)
    return state
