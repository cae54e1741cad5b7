"""Config system — Hydra/OmegaConf-equivalent, self-contained.

The reference resolves a Hydra defaults tree (``cfg/config.yaml`` +
``cfg/task/*.yaml`` + ``cfg/train/*.yaml``) with custom OmegaConf resolvers
``eq``/``contains``/``if``/``resolve_default`` (isaacgymenvs/__init__.py:8-11)
and CLI dotted overrides.  Here every task/train config is a plain nested dict
registered in Python (values resolve at *build* time so all shapes are static
for XLA), merged as: global defaults < task defaults < user YAML < CLI
overrides.  The same dotted-override grammar works: ``task.env.numEnvs=4096``,
``train.params.config.horizon_length=32``, ``num_envs=512`` shorthands.
"""
from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional

# mirror of the root config surface (reference cfg/config.yaml)
GLOBAL_DEFAULTS: Dict[str, Any] = {
    "task_name": "Cartpole",
    "experiment": "",
    "num_envs": "",
    "seed": 42,
    "torch_deterministic": False,  # accepted for CLI parity; XLA is deterministic
    "max_iterations": "",
    # accepted for parity with the reference's CLI; JAX places all state on
    # its default device (or the mesh over every visible device)
    "sim_device": "cuda:0",
    "rl_device": "cuda:0",
    "graphics_device_id": 0,
    "pipeline": "gpu",
    "multi_gpu": False,
    "test": False,
    "checkpoint": "",
    "sigma": "",
    "headless": True,
    "capture_video": False,
    "capture_video_freq": 1464,
    "capture_video_len": 100,
    "force_render": False,
    "wandb_activate": False,
    "wandb_group": "",
    "wandb_name": "",
    "wandb_entity": "",
    "wandb_project": "isaacgymenvs_ma_tpu",
    "wandb_tags": [],
    "wandb_logcode_dir": "",
    "pbt": {"enabled": False},
}


def deep_merge(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


_SCALARS = {"true": True, "false": False, "null": None, "none": None,
            "~": None}


def _split_top(s: str) -> List[str]:
    """Split on commas that are not inside brackets or quotes."""
    parts, depth, quote, cur = [], 0, None, ""
    for ch in s:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
            continue
        cur += ch
    if cur.strip():
        parts.append(cur)
    return parts


def _parse_value(s: str) -> Any:
    """A CLI override value in the YAML flow grammar Hydra accepts: bools,
    null, ints, floats, quoted strings, ``[a, b]`` lists and ``{k: v}``
    maps; anything else stays a string."""
    s = s.strip()
    if s.lower() in _SCALARS:
        return _SCALARS[s.lower()]
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if s.startswith("[") and s.endswith("]"):
        return [_parse_value(v) for v in _split_top(s[1:-1])]
    if s.startswith("{") and s.endswith("}"):
        out = {}
        for item in _split_top(s[1:-1]):
            k, _, v = item.partition(":")
            out[str(_parse_value(k))] = _parse_value(v)
        return out
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


def apply_overrides(cfg: dict, overrides: Optional[List[str]]) -> dict:
    """Dotted CLI overrides: ``a.b.c=value`` (Hydra grammar; +/++ prefixes ok)."""
    if not overrides:
        return cfg
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' is not key=value")
        key, val = ov.split("=", 1)
        key = key.lstrip("+")
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(val)
    return cfg


def resolve_default(default, value):
    """The reference's ``${resolve_default:X,${...}}`` resolver semantics."""
    return default if value in ("", None) else value


def load_yaml_if_exists(path: str) -> dict:
    """A user config file; PyYAML is needed only when one is given."""
    if path and os.path.exists(path):
        try:
            import yaml
        except ImportError as e:
            raise ImportError(
                f"reading the config file {path} needs PyYAML "
                "(pip install pyyaml)") from e
        with open(path) as f:
            return yaml.safe_load(f) or {}
    return {}


def load_task_config(task_name: str, overrides: Optional[List[str]] = None,
                     user_yaml: Optional[str] = None) -> dict:
    """Resolve a full task config dict (the reference's ``cfg.task`` subtree)."""
    from ..tasks import registry

    cfg = copy.deepcopy(registry.task_default_config(task_name))
    cfg = deep_merge(cfg, load_yaml_if_exists(user_yaml))
    cfg = apply_overrides(cfg, overrides)
    return cfg


def load_train_config(task_name: str, overrides: Optional[List[str]] = None,
                      user_yaml: Optional[str] = None) -> dict:
    from ..learning import configs as train_configs

    cfg = copy.deepcopy(train_configs.train_default_config(task_name))
    cfg = deep_merge(cfg, load_yaml_if_exists(user_yaml))
    cfg = apply_overrides(cfg, overrides)
    return cfg


def omegaconf_to_dict(cfg) -> dict:
    """API-parity shim (reference utils/reformat.py): configs are dicts here."""
    return cfg if isinstance(cfg, dict) else dict(cfg)


def print_dict(d: dict, prefix: str = ""):
    for k, v in d.items():
        if isinstance(v, dict):
            print(f"{prefix}{k}:")
            print_dict(v, prefix + "  ")
        else:
            print(f"{prefix}{k}: {v}")
