"""The K-step call (`semisup.step.multi_step`, the counterpart of the JAX
package's make_train_multi_step) and what it stands on, on the CPU at
patch 32, batch 2+2, with narrow Unet2Ds (tests/torch_unroll.py): K
steps in one call give the (K, M) metric rows and the state of K single
steps, bit for bit (K = 2, 3); a feed packs and unpacks its draws and
numbers; and a checkpoint restore writes into the state's own tensors,
so a captured step graph would keep reading the live state."""

import numpy as np
import pytest
import torch

from torch_unroll import (assert_states_equal, corpus, hp_for, index_rows,
                          new_state, single_thread)  # noqa: F401
from ust_run_tpu_torch.engine import checkpoint as ckpt
from ust_run_tpu_torch.semisup import step as pstep
from ust_run_tpu_torch.semisup.state import lr_at

pytestmark = pytest.mark.usefixtures("single_thread")


@pytest.mark.parametrize("k", [2, 3])
def test_multi_step_is_k_single_steps(k):
    hp = hp_for("fundus")
    data = corpus(hp, 4)
    single, multi = new_state(hp, 8), new_state(hp, 8)
    rows = index_rows(9, k, hp)
    want = torch.stack([pstep.step_fn(single, data, idx, hp)
                        for idx in rows])
    feeds = torch.from_numpy(pstep.draw_feeds(multi, hp, k))
    idxs = {name: torch.stack([r[name] for r in rows]) for name in rows[0]}
    got = pstep.multi_step(multi, data, idxs, feeds, hp)
    assert got.shape == (k, sum(n for _, n in pstep.metric_spec(hp)))
    assert torch.equal(got, want)
    assert_states_equal(single, multi)
    assert multi.step == k and multi.graph is None       # no graph on CPU


def test_feed_packs_draws_and_step_numbers():
    hp = hp_for("BUSI", max_iterations=7)
    st = new_state(hp, 1)
    st.step, st.epoch = 3, 0
    again = torch.Generator().manual_seed(st.host_generator.initial_seed())
    feed = pstep.draw_feed(st, hp)
    assert feed.shape == (pstep.feed_width(hp),) and feed.dtype == np.int32
    f = pstep.unpack_feed(torch.from_numpy(feed), hp)
    # the draws in the order the step used them: key, boxes, LQ fallback
    from ust_run_tpu_torch.ops import cutmix, rng
    assert np.array_equal(f["key"].numpy(), rng.draw_key(again))
    draws = cutmix.HostDraws(again)
    boxes = [cutmix.cutmix_box_params(draws, hp.patch, hp.cutmix_prob)
             for _ in range(hp.unlabel_bs)]
    assert f["boxes"].tolist() == [list(b) for b in boxes]
    assert tuple(f["fallback"].tolist()) == cutmix.cutmix_box_params(
        draws, hp.patch, p=1.0)
    alpha = min(np.float32(1) - np.float32(1) / np.float32(4),
                np.float32(hp.ema_decay))
    assert float(f["degree"]) == np.float32(3) / np.float32(7)
    assert float(f["lr"]) == lr_at(3, hp.base_lr, hp.max_iterations)
    assert (float(f["alpha"]), float(f["beta"])) == (alpha, 1 - alpha)
    assert bool(f["force_hard"])
    st.epoch = 1
    assert not bool(pstep.unpack_feed(
        torch.from_numpy(pstep.draw_feed(st, hp)), hp)["force_hard"])
    # K feeds: the next K steps' numbers, draws in sequence
    many = pstep.draw_feeds(st, hp, 3)
    assert [float(pstep.unpack_feed(torch.from_numpy(r), hp)["degree"])
            for r in many] == [np.float32(s) / np.float32(7)
                               for s in (3, 4, 5)]


def test_restore_writes_into_the_live_state():
    hp = hp_for("fundus")
    data = corpus(hp, 2)
    st = new_state(hp, 3)
    rows = index_rows(4, 2, hp)
    pstep.step_fn(st, data, rows[0], hp)
    saved = ckpt.host_copy(ckpt.state_payload(st, 1, (0, 0, 0, 0), {}))
    assert all(isinstance(g["lr"], float)
               for g in saved["optimizer"]["param_groups"])
    addresses = pstep._carried(st)
    pstep.step_fn(st, data, rows[1], hp)
    ckpt.restore_state(st, saved)
    assert pstep._carried(st) == addresses
    fresh = new_state(hp, 3)
    pstep.step_fn(fresh, data, rows[0], hp)
    assert_states_equal(st, fresh)
    # a payload from before the first update (no momentum) zeroes the
    # live buffers in place
    ckpt.restore_state(st, ckpt.host_copy(ckpt.state_payload(
        new_state(hp, 3), 0, (0, 0, 0, 0), {})))
    assert pstep._carried(st) == addresses
    assert all(not s["momentum_buffer"].any()
               for s in st.optimizer.state.values())
