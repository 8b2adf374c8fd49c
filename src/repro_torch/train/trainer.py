"""The training loop: data -> step -> metrics -> checkpoints, with resume
and the pipeline's state; the port of the JAX package's
``repro/train/trainer.py``, on the card unless the caller names another
device.  It trains every config the repo ships, on tokens and labels, as
the JAX package's trainer does (a frontend's embeddings go through
``Transformer.loss_and_metrics`` directly), and runs on the CPU with
reduced configs (``launch/train.py --reduced --device cpu``).  The batch's
draw and upload is the profiler range ``trainer.data``; the step's are
``train_step``'s."""

from __future__ import annotations

import base64
import time

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.data.pipeline import RoaringDataPipeline
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw
from repro_torch.train import train_step as TS
from repro_torch.train.checkpoint import CheckpointManager


class Trainer:
    """``model``: a ``Transformer`` of float32 masters (``cfg.param_dtype``)
    drawn from a ``torch.Generator`` seeded with ``seed`` on the device;
    ``params``: its parameters by name; ``opt_state``: AdamW's (m, v,
    step)."""

    def __init__(self, cfg, opt_cfg: adamw.AdamWConfig,
                 pipeline: RoaringDataPipeline,
                 ckpt_dir: str, ckpt_every: int = 50,
                 async_ckpt: bool = True, seed: int = 0, *, device=None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.pipeline = pipeline
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(ckpt_dir)
        self.ckpt_every = ckpt_every
        self.async_ckpt = async_ckpt
        gen = torch.Generator(self.device).manual_seed(seed)
        self.model = Transformer(cfg, device=self.device, generator=gen,
                                 param_dtype=cfg.param_dtype)
        self.model.requires_grad_(True)
        self.params = dict(self.model.named_parameters())
        self.opt_state = adamw.init_state(self.params)
        self.step = 0
        self._step = TS.make_train_step(cfg, opt_cfg)
        self.history: list[dict] = []

    def _tree(self):
        return {"params": self.params, "opt": self.opt_state}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def maybe_resume(self) -> bool:
        """Restore the newest valid checkpoint if there is one (crash
        recovery): parameters and optimizer state copied in place."""
        found = self.ckpt.restore_with_retry(self._tree())
        if found is None:
            return False
        step, tree, extra = found
        for name, p in self.params.items():
            p.copy_(tree["params"][name])
        for key in ("m", "v"):
            for name, t in self.opt_state[key].items():
                t.copy_(tree["opt"][key][name])
        self.opt_state["step"] = tree["opt"]["step"].clone()
        self.step = step
        if "pipeline" in extra:
            st = dict(extra["pipeline"])
            st["seen"] = base64.b64decode(st["seen"])
            st["keep"] = base64.b64decode(st["keep"])
            self.pipeline.load_state_dict(st)
        return True

    def _save(self):
        pstate = self.pipeline.state_dict()
        pstate["seen"] = base64.b64encode(pstate["seen"]).decode()
        pstate["keep"] = base64.b64encode(pstate["keep"]).decode()
        self.ckpt.save(self.step, self._tree(), extra={"pipeline": pstate},
                       async_=self.async_ckpt)

    def _batch(self, batch_np) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(batch_np[k])).to(
            self.device) for k in ("tokens", "labels")}

    # ------------------------------------------------------------------
    def train(self, n_steps: int, log_every: int = 10) -> list[dict]:
        for _ in range(n_steps):
            with record_function("trainer.data"):
                batch = self._batch(self.pipeline.next_batch())
            t0 = time.monotonic()
            _, self.opt_state, metrics = self._step(
                self.model, self.opt_state, batch)
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at {self.step}")
            self.step += 1
            rec = {"step": self.step, "loss": loss,
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]),
                   "router_aux": float(metrics["router_aux"]),
                   "sec": time.monotonic() - t0}
            self.history.append(rec)
            if self.step % log_every == 0:
                print(f"step {rec['step']:5d} loss {rec['loss']:.4f} "
                      f"gnorm {rec['grad_norm']:.3f} lr {rec['lr']:.2e} "
                      f"{rec['sec'] * 1e3:.0f} ms")
            if self.step % self.ckpt_every == 0:
                self._save()
        self.ckpt.wait()
        return self.history
