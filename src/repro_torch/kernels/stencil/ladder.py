"""Execution modes and the degradation ladder's state (the counterpart of
`repro.kernels.stencil.ladder`).

`MODES` is the canonical mode order and `DEGRADATION_LADDER` the canonical
ladder; `set_default_chain_mode` forces the mode of every ``mode=None``
call and `set_default_ladder` the ladder of every call that names none.
`run_ladder` is the rung loop of `fused_chain` and `ClassifyPlan`: a
`ValueError` (a misconfigured chain) always propagates, any other failure
moves to the next rung with an event recorded in `core.faultinject`, and
only the last rung's failure raises.

On the card a rung is the kernel its mode names.  No ladder is installed
by default, so a failing kernel raises; a caller who passes a ladder gets
the JAX package's behaviour over the kernel rungs, and every rung change
is recorded and counted.  One departure from the JAX package: on a CUDA
tensor no ladder, the caller's or the process default, may move to
``"ref"`` (the plain version), and neither may the process default mode
stand in for it (`ValueError`): the plain version runs on the card only
as a caller's explicit ``mode="ref"``.
"""

from __future__ import annotations

from ...core import faultinject

# every mode, fastest first: streaming (`stencil_stream`, one full-width
# tile), tiled2d (`stencil_stream` with column tiles), window
# (`stencil_chain`), ref (the plain version, no launch)
MODES = ("streaming", "tiled2d", "window", "ref")

# the canonical ladder: each rung to the right is simpler.  The last
# rung's failure always raises.
DEGRADATION_LADDER = ("streaming", "tiled2d", "window", "ref")

# the forced mode of mode=None calls; explicit mode= arguments win over it
_DEFAULT_MODE: str | None = None

_DEFAULT_LADDER: tuple[str, ...] | None = None


def set_default_chain_mode(mode: str | None) -> str | None:
    """Force the mode ``mode=None`` calls run, or None to restore the
    measured-cache-then-fit routing.  Returns the previous default."""
    global _DEFAULT_MODE
    if mode is not None and mode not in MODES:
        raise ValueError(f"set_default_chain_mode: unknown mode {mode!r}")
    prev, _DEFAULT_MODE = _DEFAULT_MODE, mode
    return prev


def default_chain_mode() -> str | None:
    return _DEFAULT_MODE


def set_default_ladder(ladder) -> tuple[str, ...] | None:
    """Install a process-default degradation ladder for calls that pass
    none (None, or an empty ladder, removes it: a rung's failure raises).
    Returns the previous default."""
    global _DEFAULT_LADDER
    if ladder is not None:
        ladder = tuple(ladder)
        for m in ladder:
            if m not in MODES:
                raise ValueError(f"set_default_ladder: unknown rung {m!r}")
        if not ladder:
            ladder = None
    prev, _DEFAULT_LADDER = _DEFAULT_LADDER, ladder
    return prev


def default_ladder() -> tuple[str, ...] | None:
    return _DEFAULT_LADDER


def resolve_rungs(mode: str, ladder, *, card: bool = False) -> tuple[str, ...]:
    """The rungs one call runs: the resolved mode first, then the ladder's
    rungs after it (the whole ladder when the mode is not a rung), each
    once.  ``ladder=None`` takes the process default; no ladder means the
    one mode, whose failure raises.  `card`: the call's tensor is on a
    CUDA device, where a move to ``"ref"`` raises `ValueError`."""
    if ladder is None:
        ladder = _DEFAULT_LADDER
    if not ladder:
        return (mode,)
    return ordered_rungs(mode, ladder, MODES, "fused_chain", card=card)


def ordered_rungs(mode: str, ladder, allowed, what: str, *, card: bool = False) -> tuple[str, ...]:
    """`mode`, then the rungs of a non-empty `ladder` after it (all of them
    when `mode` is not a rung), each once; a rung outside `allowed` raises,
    and so does, when `card`, a move to ``"ref"``."""
    ladder = tuple(ladder)
    for m in ladder:
        if m not in allowed:
            raise ValueError(f"{what}: unknown ladder rung {m!r}")
    tail = ladder[ladder.index(mode) + 1 :] if mode in ladder else ladder
    rungs = tuple(dict.fromkeys((mode, *tail)))
    if card and "ref" in rungs[1:]:
        raise ValueError(
            f"{what}: ladder {ladder} moves to 'ref' (the plain version) on a CUDA tensor; "
            "on the card a failing kernel raises, and the plain version runs only as mode='ref'"
        )
    return rungs


def run_ladder(rungs, run, *, stage: str, detail: str):
    """Try each rung in order: a `ValueError` always propagates, any other
    failure moves to the next rung with a recorded event, and the last
    rung's failure raises."""
    for i, rung in enumerate(rungs):
        try:
            return run(rung)
        except ValueError:
            raise  # a misconfigured chain must surface from every mode
        except Exception as e:
            if i == len(rungs) - 1:
                raise
            faultinject.record_degradation(
                stage=stage,
                from_plan=rung,
                to_plan=rungs[i + 1],
                reason=f"{type(e).__name__}: {e}",
                detail=detail,
                injected=isinstance(e, faultinject.InjectedFault),
            )
