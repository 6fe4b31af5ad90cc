"""The system under test: ust_run_tpu_torch's training state and the
trainer's call, built as engine/trainer.py builds them.

`Program` sets the port's numerics (`set_numerics`), builds the models
(`semisup.state.build_model`) and the train state
(`create_train_state`), loads the benchmark's weights into them and runs
the cell's call: the K-step call `semisup.step.multi_step` (a captured
CUDA graph replayed per step) or the eager `semisup.step.step_fn`. The
configuration file is checked against the port's own settings for the
dataset, so the file states what runs.
"""

import numpy as np
import torch

LOSS_COLUMN = 0         # "loss" leads the port's packed metric vector


class Program:
    def __init__(self, config, cell, seed, device, weights):
        from ust_run_tpu_torch.config import TrainConfig
        from ust_run_tpu_torch.engine.trainer import set_numerics
        from ust_run_tpu_torch.semisup import state as state_mod
        from ust_run_tpu_torch.semisup import step as step_mod

        self.S = step_mod
        cfg = TrainConfig(dataset=config["dataset"],
                          model=config["model"]["program"],
                          amp=config["amp"],
                          deterministic=config["deterministic"]).resolve()
        if cfg.profile().patch_size != config["patch"]:
            cfg.patch_override = config["patch"]
        cfg.label_bs, cfg.unlabel_bs = cell["label_bs"], cell["unlabel_bs"]
        cfg.unroll_steps = cell["steps_per_call"]
        set_numerics(cfg.deterministic, seed % 2 ** 32)
        self.hp = step_mod.HyperParams.from_config(cfg)
        check_settings(self.hp, config)
        self.device = device
        self.graph = cell["call"] == "graph"
        amp = bool(cfg.amp) and device.type == "cuda"
        init = torch.Generator().manual_seed(0)
        student, teacher = (state_mod.build_model(cfg, self.hp, init, amp)
                            for _ in range(2))
        self.state = state_mod.create_train_state(self.hp, seed, device,
                                                  student, teacher)
        self.state.student.load_state_dict(weights[0])
        self.state.teacher.load_state_dict(weights[1])
        group = self.state.optimizer.param_groups[0]
        for key in ("momentum", "weight_decay"):
            if group[key] != config["training"][key]:
                raise ValueError(f"the port's SGD {key} is {group[key]}, "
                                 f"the configuration file's "
                                 f"{config['training'][key]}")
        state_mod.reset_epoch(self.state, cell["epoch"])

    def call(self, data, idx):
        """The cell's call on `idx` ((k, batch) host index rows): returns
        the (k, M) packed metrics, on the device."""
        S, hp = self.S, self.hp
        rows = {name: S.host_to_device(np.asarray(v, np.int64), self.device)
                for name, v in idx.items()}
        k = rows["lb_idx"].shape[0]
        if not self.graph:
            return torch.stack([S.step_fn(self.state, data,
                                          {n: v[i] for n, v in rows.items()},
                                          hp) for i in range(k)])
        feeds = S.host_to_device(S.draw_feeds(self.state, hp, k),
                                 self.device)
        return S.multi_step(self.state, data, rows, feeds, hp)

    def eager_steps(self, data, idx):
        """`step_fn` on each of the rows `idx`, whatever the cell's call."""
        S, hp = self.S, self.hp
        for i in range(idx["lb_idx"].shape[0]):
            S.step_fn(self.state, data,
                      {n: S.host_to_device(np.asarray(v[i], np.int64),
                                           self.device)
                       for n, v in idx.items()}, hp)

    # ------------------------------------------------- what is compared
    def momentum(self):
        """{leaf: the optimizer's momentum buffer} of the student."""
        st = self.state.optimizer.state
        return {name: st[p]["momentum_buffer"]
                for name, p in self.state.student.named_parameters()}

    def weights(self):
        """{"student.<leaf>": parameter} of the student."""
        return {f"student.{k}": v
                for k, v in self.state.student.named_parameters()}

    def leaves(self):
        """Every tensor of the state a step writes, by leaf name."""
        s = self.state
        out = {f"student.{k}": v for k, v in s.student.state_dict().items()}
        out.update({f"teacher.{k}": v
                    for k, v in s.teacher.state_dict().items()})
        out.update({f"queue.{k}": v for k, v in s.queue.fields().items()})
        out.update({f"lq.{k}": v for k, v in s.lq.fields().items()})
        out["choice_th"] = s.choice_th
        return out

    def close(self):
        self.state.graph = None
        self.state = None


def check_settings(hp, config):
    """Raise when the port's settings for the dataset differ from the
    configuration file's."""
    t = config["training"]
    want = dict(patch=config["patch"], channels=config["channels"],
                num_classes=config["num_classes"],
                multilabel=config["multilabel"], n_part=config["n_part"],
                **{k: t[k] for k in (
                    "queue_len", "threshold", "cutmix_prob", "LB",
                    "increase", "consistency", "consistency_rampup",
                    "max_iterations", "ema_decay", "base_lr", "min_v",
                    "max_v", "fillcolor")})
    have = {k: getattr(hp, k) for k in want}
    if have != want:
        diff = {k: (have[k], want[k]) for k in want if have[k] != want[k]}
        raise ValueError(f"the port's settings differ from the "
                         f"configuration file: {diff}")
