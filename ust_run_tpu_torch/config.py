"""Experiment configuration (the PyTorch port's own copy).

The reference configures everything through ~30 argparse flags plus
hardcoded per-dataset profiles (train.py:38-79 and 404-436, domain tables
at train.py:466-471). The same public flag surface as `ust_run_tpu.config`
is kept, backed by a dataclass, plus `--device`.

Flags that only shape the JAX package's TPU program are accepted and
ignored, because they compute the same function: `pack_l1` and
`split_up` (layout forms of the same UNet). `unroll_steps` is the steps
per call, as in JAX (engine/trainer.py:unroll_of): on the card the call
replays a CUDA graph of the step. `num_devices` names the data-parallel mesh size, which in the
port is the number of ranks torchrun starts: any other value raises
(parallel.check_num_devices). `amp=1` means bf16 autocast on CUDA with
f32 parameters and f32 BatchNorm statistics.
"""

import argparse
import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DatasetProfile:
    """Per-dataset hardcoded settings (reference train.py:404-436,
    466-471; train_mnms.py:396-408)."""
    name: str
    num_channels: int
    patch_size: int
    num_classes: int
    # number of label channels carried through the pipeline:
    # fundus keeps 2 multilabel planes; others keep a single class map.
    multilabel: bool
    parts: Tuple[str, ...]
    min_v: float
    max_v: float
    fillcolor: int
    max_iterations: int
    max_domains: int
    domain_len: Tuple[int, ...]
    # host-decode resize (PIL) applied at dataset-load time
    load_size: Optional[int]

    @property
    def n_part(self):
        return len(self.parts)


PROFILES = {
    # train.py:404-414, 466-467; dataloader.py:13-149
    "fundus": DatasetProfile(
        name="fundus", num_channels=3, patch_size=256, num_classes=2,
        multilabel=True, parts=("cup", "disc"), min_v=0.5, max_v=1.5,
        fillcolor=255, max_iterations=30000, max_domains=4,
        domain_len=(50, 99, 320, 320), load_size=256),
    # train.py:415-424, 468-469; dataloader.py:151-253
    "prostate": DatasetProfile(
        name="prostate", num_channels=1, patch_size=384, num_classes=2,
        multilabel=False, parts=("base",), min_v=0.1, max_v=2.0,
        fillcolor=255, max_iterations=60000, max_domains=6,
        domain_len=(225, 305, 136, 373, 338, 133), load_size=None),
    # train.py:426-436, 470-471; dataloader.py:356-444
    "BUSI": DatasetProfile(
        name="BUSI", num_channels=1, patch_size=256, num_classes=2,
        multilabel=False, parts=("base",), min_v=0.1, max_v=2.0,
        fillcolor=0, max_iterations=30000, max_domains=2,
        domain_len=(350, 168), load_size=256),
    # train_mnms.py:396-408 (4 vendors, 288px, 4 classes incl. background)
    "MNMS": DatasetProfile(
        name="MNMS", num_channels=1, patch_size=288, num_classes=4,
        multilabel=False, parts=("lv", "myo", "rv"), min_v=0.1, max_v=2.0,
        fillcolor=0, max_iterations=60000, max_domains=4,
        domain_len=(1030, 1342, 525, 550), load_size=288),
}

# default data roots, matching reference train.py:966-971 / README.md:15-24
DEFAULT_DATA_ROOTS = {
    "fundus": "../../data/Fundus",
    "prostate": "../../data/ProstateSlice",
    "BUSI": "../../data/Dataset_BUSI_with_GT",
    "MNMS": "../../data/mnms",
}


@dataclasses.dataclass
class TrainConfig:
    """All training hyperparameters. Field names/defaults mirror the
    reference argparse block (train.py:38-79)."""
    dataset: str = "BUSI"
    save_name: str = "debug"
    overwrite: bool = False
    model: str = "unet"
    max_iterations: int = 60000
    num_eval_iter: int = 500
    deterministic: int = 1
    base_lr: float = 0.03
    seed: int = 1337
    gpu: str = "0"                      # accepted for CLI compat; see --device
    load: bool = False
    eval: bool = False
    load_path: str = "../model/lb1_ratio0.2/iter_6000.pth"  # dead flag (parity)
    threshold: float = 0.95
    amp: int = 1                        # 1 -> bf16 autocast on CUDA
    label_bs: int = 4
    unlabel_bs: int = 4
    test_bs: int = 1
    domain_num: int = 6
    lb_domain: int = 1
    lb_num: int = 40
    lb_ratio: float = 0.0
    ema_decay: float = 0.99
    consistency_type: str = "mse"       # dead flag (parity)
    consistency: float = 1.0
    consistency_rampup: float = 200.0
    depth: int = 28                     # dead flags (parity, train.py:69-73)
    widen_factor: int = 2
    leaky_slope: float = 0.1
    bn_momentum: float = 0.1
    dropout: float = 0.0
    cutmix_prob: float = 1.0
    LB: float = 0.01
    increase: float = 1.0005
    queue_len: int = 10
    # --- extensions (not in the reference CLI) ---
    data_root: Optional[str] = None     # override the hardcoded data path
    model_root: str = "../model"        # snapshot parent dir (train.py:965)
    num_devices: Optional[int] = None   # data-parallel mesh size (= ranks)
    eval_batch: int = 8                 # padded eval batch (ref uses bs=1)
    log_interval: int = 50              # host metric fetch cadence
    profile_dir: Optional[str] = None   # torch.profiler trace of steps 2-3
    patch_override: Optional[int] = None  # shrink patch size (smoke tests)
    unroll_steps: int = 10              # steps per call (CUDA graph replays)
    # ImageNet-pretrained backbone weights dir for the DeepLab configs;
    # default mirrors the reference's hardcoded load path
    # (networks/backbone/resnet.py:185-190). Expects <root>/<arch>.pth.
    pretrained_root: str = "../../checkpoints/pretrained"
    # Apply the LQ consistency term. Upstream this branch is dead code
    # (train.py:743 vs :822 — see semisup.step.HyperParams.lq_loss);
    # False reproduces the reference objective exactly.
    lq_consistency: bool = False
    # TPU layout options of the JAX UNet (W-packed level 1, split Up
    # convs). Same function as the plain UNet: accepted and ignored.
    pack_l1: int = 1
    split_up: int = 1
    # "cuda" (default; cuda:LOCAL_RANK under torchrun), "cuda:N" or "cpu";
    # there is no silent fallback.
    device: str = "cuda"

    def profile(self) -> DatasetProfile:
        p = PROFILES[self.dataset]
        if self.patch_override:
            p = dataclasses.replace(
                p, patch_size=self.patch_override,
                load_size=self.patch_override if p.load_size else None)
        return p

    def resolve(self):
        """Apply the per-dataset overrides the reference performs inside
        train() (train.py:404-436): batch sizes, max_iterations, and the
        domain_num clamp."""
        p = self.profile()
        self.label_bs = 4
        self.unlabel_bs = 4
        # the reference unconditionally overwrites max_iterations from the
        # dataset profile (train.py:412,423,434); we honor an explicit
        # non-default value so short smoke runs are possible from the CLI.
        if self.max_iterations == 60000:
            self.max_iterations = p.max_iterations
        self.domain_num = min(self.domain_num, p.max_domains)
        if self.data_root is None:
            self.data_root = DEFAULT_DATA_ROOTS[self.dataset]
        return self

    def labeled_count(self) -> int:
        """lb_ratio overrides lb_num when positive (train.py:474-477)."""
        p = self.profile()
        if self.lb_ratio > 0:
            return int(sum(p.domain_len) * self.lb_ratio)
        return self.lb_num


def build_parser(default_dataset="BUSI", mnms=False) -> argparse.ArgumentParser:
    """Argparse surface identical to `ust_run_tpu.config.build_parser`
    (the reference's train.py:38-79 / train_mnms.py:38-78 plus its
    extensions), plus `--device`."""
    parser = argparse.ArgumentParser()
    if mnms:
        parser.add_argument("--dataset", type=str, default="MNMS")
    else:
        parser.add_argument("--dataset", type=str, default=default_dataset,
                            choices=["fundus", "prostate", "BUSI"])
    parser.add_argument("--save_name", type=str, default="debug")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument(
        "--model", type=str, default="unet",
        help="unet (bf16 with --amp 1), transunet (R50-ViT-B/16, bf16 with "
             "--amp 1 but a float32 stem; one device), or the float32 zoo: "
             "unet2d, unet2d_dsbn, deeplabv2, deeplabv2_r50")
    parser.add_argument("--max_iterations", type=int, default=60000)
    parser.add_argument("--num_eval_iter", type=int, default=500)
    parser.add_argument("--deterministic", type=int, default=1)
    parser.add_argument("--base_lr", type=float, default=0.03)
    parser.add_argument("--seed", type=int, default=1337)
    parser.add_argument("--gpu", type=str, default="0")
    parser.add_argument("--load", action="store_true")
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--load_path", type=str,
                        default="../model/lb1_ratio0.2/iter_6000.pth")
    parser.add_argument("--threshold", type=float, default=0.95)
    parser.add_argument("--amp", type=int, default=1)
    parser.add_argument("--label_bs", type=int, default=4)
    parser.add_argument("--unlabel_bs", type=int, default=4)
    parser.add_argument("--test_bs", type=int, default=1)
    parser.add_argument("--domain_num", type=int, default=6)
    parser.add_argument("--lb_domain", type=int, default=1)
    parser.add_argument("--lb_num", type=int, default=40)
    parser.add_argument("--lb_ratio", type=float, default=0)
    parser.add_argument("--ema_decay", type=float, default=0.99)
    parser.add_argument("--consistency_type", type=str, default="mse")
    parser.add_argument("--consistency", type=float, default=1.0)
    parser.add_argument("--consistency_rampup", type=float, default=200.0)
    parser.add_argument("--depth", type=int, default=28)
    parser.add_argument("--widen_factor", type=int, default=2)
    parser.add_argument("--leaky_slope", type=float, default=0.1)
    parser.add_argument("--bn_momentum", type=float, default=0.1)
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--cutmix_prob", default=1.0, type=float)
    parser.add_argument("--LB", default=0.01, type=float)
    parser.add_argument("--increase", default=1.0005, type=float)
    parser.add_argument("--queue_len", default=10, type=int)
    # extensions
    parser.add_argument("--data_root", type=str, default=None,
                        help="override the hardcoded dataset root")
    parser.add_argument("--model_root", type=str, default="../model",
                        help="snapshot parent directory")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="data-parallel mesh size; must equal the "
                             "number of ranks torchrun starts")
    parser.add_argument("--eval_batch", type=int, default=8)
    parser.add_argument("--log_interval", type=int, default=50)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler Chrome trace of the "
                             "first epoch's steps 2-3 here (one file per "
                             "rank)")
    parser.add_argument("--patch_override", type=int, default=None,
                        help="override the dataset patch size (smoke tests)")
    parser.add_argument("--unroll_steps", type=int, default=10,
                        help="steps per call when it divides num_eval_iter "
                             "(else 1): on CUDA one captured CUDA graph of "
                             "the step replayed per step, on the CPU and "
                             "with a mesh eager steps; 1 = one eager step "
                             "per call")
    parser.add_argument("--pretrained_root", type=str,
                        default="../../checkpoints/pretrained",
                        help="dir holding ImageNet resnet50/101.pth for "
                             "the DeepLab configs (resnet.py:185-190)")
    parser.add_argument("--lq_consistency", action="store_true",
                        help="apply the LQ consistency term (dead code "
                             "upstream, train.py:743 vs :822; off = "
                             "reference-faithful objective)")
    parser.add_argument("--pack_l1", type=int, default=1,
                        help="TPU layout option of the JAX UNet; accepted "
                             "and ignored (same function)")
    parser.add_argument("--split_up", type=int, default=1,
                        help="TPU layout option of the JAX UNet; accepted "
                             "and ignored (same function)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; cuda:LOCAL_RANK under "
                             "torchrun; raises if absent), cuda:N or cpu")
    return parser


def config_from_args(args) -> TrainConfig:
    cfg = TrainConfig()
    for f in dataclasses.fields(TrainConfig):
        if hasattr(args, f.name):
            setattr(cfg, f.name, getattr(args, f.name))
    return cfg
