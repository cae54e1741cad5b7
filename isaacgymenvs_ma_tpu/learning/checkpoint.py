"""Checkpoint save/restore (rl_games ``.pth`` checkpoint equivalent).

The reference saves model weights + optimizer + frame counter + running
mean/std into ``runs/<exp>/nn/*.pth`` every ``save_frequency`` epochs and
restores via ``checkpoint=`` (SURVEY.md §5; cfg/train/AntPPO.yaml:36-38).
Here the whole :class:`PPOState` pytree (params, optimizer, normalizers,
LR, counters) is saved as its list of numpy leaves, keyed by tree path, and
restored into the structure of a template state; env curriculum state
(``get_env_state``/``set_env_state`` — vec_task.py:197-205) rides along,
so ADR ranges / tolerance curricula resume exactly.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Optional

import jax
import numpy as np


def _paths(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def save_checkpoint(path: str, state, env_state_extra: Any = None,
                    meta: Optional[dict] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    host_state = jax.device_get(state)
    payload = {
        "paths": _paths(host_state),
        "leaves": [np.asarray(x) for x in jax.tree_util.tree_leaves(host_state)],
        "env_state_extra": env_state_extra,
        "meta": meta or {},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


def load_checkpoint(path: str, template_state):
    with open(path, "rb") as f:
        payload = pickle.load(f)
    want = _paths(template_state)
    if payload["paths"] != want:
        missing = sorted(set(want) - set(payload["paths"]))[:5]
        extra = sorted(set(payload["paths"]) - set(want))[:5]
        raise ValueError(f"checkpoint {path} does not match the state: "
                         f"missing {missing}, unexpected {extra}")
    state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template_state), payload["leaves"])
    return state, payload.get("env_state_extra"), payload.get("meta", {})
