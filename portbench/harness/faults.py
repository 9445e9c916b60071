"""Faults planted under the timed path, to show that the comparison
catches them (the calibration on the card, the tests on the CPU). Each is a
context manager that patches one function of the program and restores it.

Training: ``unchanged_state``, an optimizer step that returns the params
and moments as they were; ``half_batch``, a loss over the first half of the
batch's rows (their mean). Serving: ``altered_token``, every decode step's
token moved by one where it is produced; ``unchanged_state``, decode steps
that leave the recurrent state as it was.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name: str, make):
    saved = getattr(module, name)
    setattr(module, name, make(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)


def train_unchanged_state():
    from repro_torch.optim import adamw

    def make(apply_updates):
        def frozen(cfg, params, grads, state):
            new = adamw.OptState(step=state.step + 1, master=state.master, m=state.m, v=state.v)
            return params, new, {"grad_norm": adamw.global_norm(grads),
                                 "lr": adamw.schedule(cfg, new.step)}
        return frozen
    return _patched(adamw, "apply_updates", make)


def train_half_batch():
    from repro_torch.models import lm

    def make(train_loss):
        def half(cfg, params, batch):
            return train_loss(cfg, params, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
        return half
    return _patched(lm, "train_loss", make)


def serve_altered_token():
    from repro_torch.runtime import steps

    def make(make_decode_step):
        def making(cfg, *a, **kw):
            decode = make_decode_step(cfg, *a, **kw)

            def altered(params, cache, token, pos):
                nxt, logits, cache = decode(params, cache, token, pos)
                return (nxt + 1) % cfg.vocab_size, logits, cache
            return altered
        return making
    return _patched(steps, "make_decode_step", make)


def serve_unchanged_state():
    from repro_torch.runtime import steps

    def make(make_decode_step):
        def making(cfg, *a, **kw):
            decode = make_decode_step(cfg, *a, **kw)

            def stale(params, cache, token, pos):
                scratch = {k: v.clone() for k, v in cache.items()}
                nxt, logits, _ = decode(params, scratch, token, pos)
                return nxt, logits, cache
            return stale
        return making
    return _patched(steps, "make_decode_step", make)


TRAIN = {"unchanged_state": train_unchanged_state, "half_batch": train_half_batch}
SERVE = {"altered_token": serve_altered_token, "unchanged_state": serve_unchanged_state}
