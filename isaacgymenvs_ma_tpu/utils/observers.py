"""Training observers (reference utils/rlgames_utils.py:130-239 + wandb_utils).

``AlgoObserver`` equivalents: episode-info aggregation to TensorBoard
(``RLGPUAlgoObserver`` — Episode/* scalars, flattened extras), a fan-out
``MultiObserver``, and an optional W&B observer with retry/resume
(utils/wandb_utils.py:7-57).  Metrics arrive as a flat host dict once per
log interval — no device sync inside the training loop.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional


class AlgoObserver:
    def after_init(self, config: dict):
        pass

    def after_print_stats(self, epoch: int, metrics: Dict[str, float]):
        pass

    def after_steps(self, epoch: int, frames: int, metrics: Dict[str, float]):
        pass


class TensorboardObserver(AlgoObserver):
    """Writes Episode/* and losses/* scalars (rlgames_utils.py:149-209).

    tensorboardX is optional: without it the observer says so once and
    records nothing."""

    def __init__(self, logdir: str):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            print("[observers] tensorboardX not installed; "
                  "TensorBoard summaries disabled")
            self.writer = None
            return
        os.makedirs(logdir, exist_ok=True)
        self.writer = SummaryWriter(logdir)

    def after_print_stats(self, epoch, metrics):
        if self.writer is None:
            return
        frames = int(metrics.get("frames", epoch))
        for k, v in metrics.items():
            if k == "frames":
                continue
            section = "losses" if "loss" in k else (
                "Episode" if k.startswith("episode_") or k.startswith("mean_")
                else "info")
            self.writer.add_scalar(f"{section}/{k}", float(v), frames)
        self.writer.flush()


class ConsoleObserver(AlgoObserver):
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.t0 = time.time()

    def after_print_stats(self, epoch, metrics):
        pass  # the agent already prints


class MultiObserver(AlgoObserver):
    """Fan-out composite (rlgames_utils.py:212-239)."""

    def __init__(self, *observers: AlgoObserver):
        self.observers = [o for o in observers if o is not None]

    def after_init(self, config):
        for o in self.observers:
            o.after_init(config)

    def after_print_stats(self, epoch, metrics):
        for o in self.observers:
            o.after_print_stats(epoch, metrics)

    def after_steps(self, epoch, frames, metrics):
        for o in self.observers:
            o.after_steps(epoch, frames, metrics)


class WandbObserver(AlgoObserver):
    """W&B init with retry + tensorboard sync (utils/wandb_utils.py:7-57).

    Gated import: wandb is not baked into the image, so this degrades to a
    no-op with a warning when unavailable.
    """

    def __init__(self, project: str, group: str = "", name: str = "",
                 entity: str = "", tags=(), resume_uid: Optional[str] = None):
        self.enabled = False
        try:
            import wandb  # noqa
            for attempt in range(3):
                try:
                    wandb.init(project=project, group=group or None,
                               name=name or None, entity=entity or None,
                               tags=list(tags), id=resume_uid, resume="allow",
                               sync_tensorboard=True)
                    self.enabled = True
                    break
                except Exception:
                    time.sleep(2 * (attempt + 1))
        except ImportError:
            print("[observers] wandb not installed; WandbObserver disabled")
        self._wandb = None if not self.enabled else __import__("wandb")

    def after_print_stats(self, epoch, metrics):
        if self.enabled:
            self._wandb.log({k: float(v) for k, v in metrics.items()},
                            step=int(metrics.get("frames", epoch)))
