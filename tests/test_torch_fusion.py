"""The port's atlas losses, bundle adjustment, Fuser and pooled train step
against the JAX package's, on the CPU.

The atlases are tests/test_torch_atlas.py's (three submaps of different
bounds, two keyframes each, random features, stability, decoder and pose
corrections carried across).  Batches are made with numpy from a seed:
keyframe-frame points, global keyframe ids, SDF labels, validity and signs.

Tolerances: loss values 1e-5 relative; gradients (features, stability,
submap and keyframe poses) 1e-4 of each tensor's largest entry; parameters
after masked Adam steps 2e-6 absolute (float32 rounding of values near 1;
an Adam step moves an entry by about its rate times the sign of its
gradient, 1e-4 to 1e-3 here, and the gradients sit clearly off zero under
the L2 loss).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miso_tpu import config as j_config
from miso_tpu.align import miso as j_align
from miso_tpu.losses import fusion as j_fusion
from miso_tpu.losses.common import total_loss as j_total
from miso_tpu.ops import diff as j_diff
from miso_tpu.slam.fuser import Fuser as JFuser
from miso_tpu.train import optim as j_optim
from miso_tpu.train import trainer as j_trainer
from miso_tpu_torch import config as t_config
from miso_tpu_torch.align import miso as t_align
from miso_tpu_torch.losses import common as t_common
from miso_tpu_torch.losses import fusion as t_fusion
from miso_tpu_torch.losses.common import total_loss
from miso_tpu_torch.slam.fuser import Fuser
from miso_tpu_torch.train import trainer as t_trainer
from miso_tpu_torch.train.optim import masked_adam_init
from test_torch_atlas import pair

FUSE_CFG = {"mapping": {"loss_type": "L2", "weight_sdf": 1.0, "weight_eik": 0.0,
                        "weight_fs": 0.3, "trunc_dist": 0.5, "finite_diff_eps": 0.1,
                        "grad_method": "finitediff", "eik_trunc_dist": 0.5},
            "align": {"level_iters": 3, "finetune_iters": 3, "learning_rate": 5e-3,
                      "latent_levels": [1], "skip_finetune": False, "max_points": 500}}
PARAMS = ("features", "stability", "sub_rot_corr", "sub_trans_corr", "kf_rot_corr",
          "kf_trans_corr")


def np_(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def atlases():
    return pair(seed=11)


@pytest.fixture
def fresh(atlases):
    """Copies of the module's atlases for a test that trains them: the JAX
    atlas's params are replaced, never written; the port's are written in
    place."""
    ja, ta = atlases
    return copy.copy(ja), copy.deepcopy(ta)


def batch_np(n=1500, seed=0, num_kfs=6):
    r = np.random.default_rng(seed)
    return {"coords_frame": r.uniform(-1.2, 1.2, (n, 3)).astype(np.float32),
            "sample_frame_ids": r.integers(0, num_kfs, n).astype(np.int32),
            "sdf": r.normal(0, 0.3, (n, 1)).astype(np.float32),
            "sdf_valid": (r.uniform(size=(n, 1)) < 0.85).astype(np.float32),
            "sdf_signs": r.choice([-1.0, 0.0, 1.0], (n, 1)).astype(np.float32),
            "weights": r.uniform(0.5, 1.5, (n, 1)).astype(np.float32)}


def jax_leaf(tree, name, like):
    """The JAX atlas leaf of the port's parameter ``name``, in the port's
    (unfolded) shape of ``like``."""
    head, _, idx = name.partition(".")
    leaf = getattr(tree, head)
    if head in ("features", "stability"):
        leaf = leaf[int(idx)]
    return np.asarray(leaf).reshape(tuple(like.shape))


def compare_grads(tp, jgrads):
    checked = 0
    for name, p in tp.named_parameters():
        if name.partition(".")[0] not in PARAMS:
            continue
        ref = jax_leaf(jgrads, name, p)
        got = np.zeros_like(ref) if p.grad is None else np_(p.grad)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * max(np.abs(ref).max(), 1e-30),
                                   err_msg=name)
        checked += np.abs(ref).max() > 0
    return checked


def losses_and_grads(ja, ta, t_loss, j_loss, batch, key_t=None, key_j=None):
    """(port loss dict, JAX loss dict), the port's gradients on a trimmed
    copy of its params, the JAX gradients."""
    tp = ta.params.trim(ta.num_submaps).requires_grad_()
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    got = t_loss(tp, tb, key_t)
    total_loss(got).backward()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def j_total_and_dict(p):
        d = j_loss(p, jb, key_j)
        return j_total(d), d

    (_, ref), jg = jax.value_and_grad(j_total_and_dict, has_aux=True, allow_int=True)(ja.params)
    return got, ref, tp, jg


def compare_values(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("loss_type,weight_fs", [("L2", 0.3), ("L1", 0.1)])
def test_fusion_loss_matches_jax(atlases, loss_type, weight_fs):
    ja, ta = atlases
    kw = dict(loss_type=loss_type, weight_fs=weight_fs, trunc_dist=0.2)
    got, ref, tp, jg = losses_and_grads(
        ja, ta, lambda p, b, k: t_fusion.fusion_loss(p, b, k, **kw),
        lambda p, b, k: j_fusion.fusion_loss(p, b, k, **kw), batch_np())
    compare_values(got, ref)
    assert compare_grads(tp, jg) == 6   # every tensor but the stability has a gradient


@pytest.mark.parametrize("mode,loss_type,pose_reg", [("submap", "L2", 0.0), ("submap", "L1", 0.5),
                                                     ("world", "L2", 0.5), ("world", "L1", 0.0)])
def test_posed_sdf_loss_3d_submap_matches_jax(atlases, mode, loss_type, pose_reg):
    ja, ta = atlases
    kw = dict(mode=mode, loss_type=loss_type, pose_reg_weight=pose_reg, trunc_dist=0.2)
    got, ref, tp, jg = losses_and_grads(
        ja, ta, lambda p, b, k: t_fusion.posed_sdf_loss_3d_submap(p, b, k, **kw),
        lambda p, b, k: j_fusion.posed_sdf_loss_3d_submap(p, b, k, **kw), batch_np(seed=1))
    compare_values(got, ref)
    # In submap mode the submap poses enter only through the regulariser.
    assert compare_grads(tp, jg) == (4 if mode == "submap" and not pose_reg else 6)


@pytest.mark.parametrize("grad_method", ["finitediff", "autograd"])
def test_smoothness_loss_matches_jax(atlases, grad_method):
    """On a small tanh MLP field: the port's noise, drawn from its generator,
    given to the JAX formula gives the same loss and parameter gradients.
    Then ``posed_sdf_loss_3d_submap``'s world mode adds it on the atlas,
    weighted."""
    r = np.random.default_rng(2)
    W = r.normal(0, 1, (3, 16)).astype(np.float32)
    v = r.normal(0, 1, (16, 1)).astype(np.float32)
    x = r.uniform(-1, 1, (400, 3)).astype(np.float32)
    valid = (r.uniform(size=(400, 1)) < 0.8).astype(np.float32)
    std, eps = 0.05, 0.05
    noise = torch.randn((400, 3), generator=torch.Generator().manual_seed(4)) * std
    Wt, vt = torch.tensor(W, requires_grad=True), torch.tensor(v, requires_grad=True)
    got = t_common.smoothness_loss(lambda p: torch.tanh(p @ Wt) @ vt, torch.tensor(x),
                                   torch.tensor(valid), torch.Generator().manual_seed(4), std,
                                   grad_method, eps)
    got.backward()

    def ref_fn(W, v):
        def field(p):
            return jnp.tanh(p @ W) @ v
        g1 = j_diff.gradient3d(jnp.asarray(x), field, method=grad_method, finite_diff_eps=eps)
        g2 = j_diff.gradient3d(jnp.asarray(x) + jnp.asarray(np_(noise)), field,
                               method=grad_method, finite_diff_eps=eps)
        return jnp.mean(jnp.where(jnp.asarray(valid) == 1, g1 - g2, 0.0) ** 2)

    ref, (gW, gv) = jax.value_and_grad(ref_fn, argnums=(0, 1))(jnp.asarray(W), jnp.asarray(v))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    for t_, g in ((Wt, gW), (vt, gv)):
        np.testing.assert_allclose(np_(t_.grad), np.asarray(g), rtol=0,
                                   atol=1e-4 * float(np.abs(np.asarray(g)).max()))
    ja, ta = atlases
    tp = ta.params.trim(ta.num_submaps).requires_grad_()
    tb = {k: torch.tensor(v) for k, v in batch_np(seed=3).items()}
    kw = dict(mode="world", grad_method=grad_method, finite_diff_eps=eps, smooth_std=std)
    with_s = t_fusion.posed_sdf_loss_3d_submap(tp, tb, torch.Generator().manual_seed(5),
                                               smooth_weight=2.0, **kw)
    without = t_fusion.posed_sdf_loss_3d_submap(tp, tb, None, **kw)
    assert with_s.keys() - without.keys() == {"smooth"} and float(with_s["smooth"]) > 0
    np.testing.assert_allclose(float(with_s["sdf"]), float(without["sdf"]), rtol=1e-6)


class BatchSource:
    """``sample(rng)``: a fresh batch_np from the numpy generator."""

    def sample(self, rng):
        return batch_np(n=800, seed=int(rng.integers(1 << 30)))


def test_bundle_adjustment_matches_jax(fresh):
    ja, ta = fresh
    start = {n: np_(p).copy() for n, p in ta.params.named_parameters()}
    ref = j_align.bundle_adjust_multiple_submaps(ja, BatchSource(), num_epochs=3, seed=1)
    got = t_align.bundle_adjust_multiple_submaps(ta, BatchSource(), num_epochs=3, seed=1)
    np.testing.assert_allclose(got["final_loss"], ref["final_loss"], rtol=1e-5)
    moved = 0
    for name, p in ta.params.named_parameters():
        if name.partition(".")[0] not in PARAMS:
            continue
        np.testing.assert_allclose(np_(p), jax_leaf(ja.params, name, p), rtol=0, atol=2e-6,
                                   err_msg=name)
        moved += np.abs(np_(p) - start[name]).max() > 0
    assert moved == 6
    assert float(ta.params.sub_trans_corr[0].sub(torch.tensor(start["sub_trans_corr"][0]))
                 .abs().max()) == 0.0      # submap 0 anchored


def test_fuser_step_matches_jax(fresh):
    """One step of the Fuser's loss and masks (its defaults' rates) on a
    fixed batch through make_train_step, against the JAX Fuser's."""
    ja, ta = fresh
    S = ta.num_submaps
    tp = ta.params.trim(S).requires_grad_()
    mask = Fuser._fuse_mask(tp, 1e-3, 1e-4, 1e-4)
    step = t_trainer.make_train_step(Fuser(ta, None, FUSE_CFG)._fuse_loss(), "adam")
    b = batch_np(seed=4)
    tp, _, tl, _ = step(tp, masked_adam_init(tp), {k: torch.tensor(v) for k, v in b.items()},
                        None, mask, 1.0)
    jp = ja.params.trim(S)
    jstep = j_trainer.make_train_step(JFuser(ja, None, FUSE_CFG)._fuse_loss(), "adam")
    jp, _, jtl, _ = jstep(jp, j_optim.masked_adam_init(jp),
                          {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0),
                          JFuser._fuse_mask(jp, 1e-3, 1e-4, 1e-4), jnp.float32(1.0))
    np.testing.assert_allclose(float(tl), float(jtl), rtol=1e-5)
    for name, p in tp.named_parameters():
        if name.partition(".")[0] in PARAMS:
            np.testing.assert_allclose(np_(p), jax_leaf(jp, name, p), rtol=0, atol=2e-6,
                                       err_msg=name)


class TinyPool:
    """A device pool as ``datasets/sequence.py::SdfSequence.device_pool``
    gives it: 4 keyframes of up to 300 rows, the last with 120."""

    num_kfs = 4

    def __init__(self):
        b = batch_np(n=4 * 300, seed=7)
        self.pool = {k: torch.tensor(b[k]).reshape(4, 300, -1)
                     for k in ("coords_frame", "sdf", "sdf_valid", "sdf_signs")}
        self.n_rows = torch.tensor([300, 300, 300, 120], dtype=torch.int32)
        self.unselected = False

    def unselect_keyframes(self):
        self.unselected = True

    def device_pool(self, device="cuda"):
        return self.pool, torch.arange(4), self.n_rows, 300


def test_fuse_runs_and_writes_back():
    """Fuser.fuse on the CPU: the pooled steps train features and both pose
    groups of the live slots, written back into the atlas; spare slots stay
    as they were."""
    _, ta = pair(seed=14, capacity=5)
    before = {n: p.clone() for n, p in ta.params.named_parameters()}
    ds = TinyPool()
    fuser = Fuser(ta, ds, FUSE_CFG)
    loss = fuser.fuse(iterations=3, max_points_per_iter=512)
    assert ds.unselected and np.isfinite(loss)
    info = fuser.last_fuse_info
    assert info["iterations"] == 3 and info["trimmed_slots"] == 3
    after = dict(ta.params.named_parameters())
    for name in ("features.1", "sub_trans_corr", "kf_trans_corr"):
        assert float((after[name][:3] - before[name][:3]).abs().max()) > 0, name
        assert torch.equal(after[name][3:], before[name][3:]), name
    assert torch.equal(after["decoder.0"], before["decoder.0"])


def test_train_step_pool_row_selection():
    """The pooled step's batch: N rows, each of a keyframe below k_live and a
    row below that keyframe's count, the pool's values there, unit weights;
    every such keyframe drawn."""
    ds = TinyPool()
    seen = {}

    def loss_fn(model, batch, key):
        seen.update(batch)
        return {"l": (model.w ** 2).sum()}

    model = torch.nn.Linear(1, 1)
    model.w = model.weight
    step = t_trainer.make_train_step_pool(loss_fn, "adam")
    gen = torch.Generator().manual_seed(0)
    N = 4000
    step(model, masked_adam_init(model), ds.pool, ds.n_rows, 3, gen,
         {n: torch.tensor(1.0) for n, _ in model.named_parameters()}, 1e-3, N)
    kf = seen["sample_frame_ids"].long()
    assert seen["sample_frame_ids"].dtype == torch.int32 and kf.shape == (N,)
    assert set(kf.tolist()) == {0, 1, 2}
    flat = ds.pool["coords_frame"].reshape(-1, 3)
    rows = [int(torch.nonzero((flat == c).all(-1))[0]) for c in seen["coords_frame"][:200]]
    for k, r in zip(kf[:200].tolist(), rows):
        assert r // 300 == k and r % 300 < int(ds.n_rows[k])
    assert torch.equal(seen["weights"], torch.ones((N, 1)))
    assert seen["sdf"].shape == (N, 1)


def test_trim_and_scatter_roundtrip():
    _, ta = pair(seed=15, capacity=5)
    t = ta.params.trim(3)
    assert t.capacity == 3 and t.num_submaps == 3
    assert all(a.data_ptr() != b.data_ptr() for (_, a), (_, b) in
               zip(t.named_parameters(), ta.params.named_parameters()))
    with torch.no_grad():
        t.features[0] += 1.0
        t.kf_rot_corr += 0.5
    ta.params.scatter_trimmed(t)
    assert torch.equal(ta.params.features[0][:3], t.features[0])
    assert torch.equal(ta.params.kf_rot_corr[:3], t.kf_rot_corr)


@pytest.mark.parametrize("name", ["MisoFusion", "PosedSdf3DSubmap", "iSDFSubmap"])
def test_cfg_atlas_losses_match_jax(atlases, name):
    """The config registry's atlas losses, built from the same config."""
    ja, ta = atlases
    cfg = {"loss": {"name": name, "sdf_weight": 2.0, "sign_weight": 0.5, "trunc_dist": 0.2},
           "mapping": dict(FUSE_CFG["mapping"], weight_fs=0.2)}
    b = batch_np(seed=5)
    got = t_config.cfg_loss(cfg)(ta.params, {k: torch.tensor(v) for k, v in b.items()}, None)
    ref = j_config.cfg_loss(cfg)(ja.params, {k: jnp.asarray(v) for k, v in b.items()},
                                 jax.random.PRNGKey(0))
    compare_values(got, ref)
