"""The port's sharded train step against the reference's unsharded step,
and against the port's own.

The reference's own mesh path cannot be the oracle: under jax 0.9 its
sharded ``run_training`` fails inside the jitted step (ROADMAP, queue 3).
Its ``make_train_step`` without a mesh runs, and the port's (2, 2) step
on four CPU chips computes the reference's ``microbatches=2`` arithmetic
(two data groups, each a microbatch), so each architecture at
``reduced()`` takes one step in both from the reference's weights
(``torch_model_fixtures``): loss and grad norm at rtol = atol = 1e-5,
every gradient (read through ``grad_transform``, gathered from its
blocks) at 1e-5, and the updated parameters at 1e-5 where the clipped
gradient |g'| >= 10 eps and within 2 lr elsewhere (the bound
``tests/test_torch_train.py`` states: AdamW's first step moves an
element by lr · g' / (|g'| + eps), which a last-bit difference in a g'
near 0 can flip).

The same (2, 2) step against the port's unsharded ``microbatches=2``
step from the same weights, state and batch: the data groups'
arithmetic is the microbatches', but each group splits its heads,
``d_ff``, experts and vocabulary over its two model chips, whose partial
sums add in another order than the whole products (and the loss's
cross-entropy reduces over vocabulary shards), so loss and grad norm
are held at rtol = atol = 1e-5, the gradients and moments at 1e-5, and
the updated parameters by the rule above.

The reference's jamba step compiles for most of a minute on the CPU, so
the architectures are split over three files
(``test_torch_mesh_step_ref{,2,3}.py``) that parallel pytest workers run
side by side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import Model as RefModel
from repro.optim import adamw as ref_adamw
from repro.train import train_step as ref_train_step
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Model
from repro_torch.optim import AdamW
from repro_torch.pytree import tree_leaves
from repro_torch.train import make_train_step

from torch_model_fixtures import tokens, weights
from torch_mesh_fixtures import one_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def params_close(got, want, grads, grad_norm, lr, eps):
    """The parameter rule: each updated element within 1e-5 where the
    clipped gradient |g'| >= 10 eps, within 2 lr elsewhere."""
    scale = min(1.0, 1.0 / (grad_norm + 1e-9))
    for a, b, g in zip(got, want, grads):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        firm = np.abs(np.asarray(g)) * scale >= 10 * eps
        diff = np.abs(a - b)
        assert np.all(diff[firm] <= 1e-5 + 1e-5 * np.abs(b[firm]))
        assert np.all(diff[~firm] <= 2 * lr + 1e-5)


def _capture(into):
    def transform(grads):
        into.append(grads)
        return grads
    return transform


ARCH_FILES = (("jamba-1.5-large-398b",),
              ("rwkv6-1.6b", "llama-3.2-vision-11b", "longformer-1.4b",
               "llama4-scout-17b-a16e"))


def check_against_reference(arch):
    rcfg, cfg, rp, tp = weights(arch, seed=6)
    tok, img = tokens(cfg, 4, 17, seed=6)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if img is not None:
        batch["image_embeds"] = img
    lr, eps = 1e-3, 1e-8
    r_opt = ref_adamw.AdamW(learning_rate=lr, eps=eps)
    r_grads, t_grads = [], []
    r_step = ref_train_step.make_train_step(
        RefModel(rcfg), r_opt, microbatches=2, chunk_q=8,
        grad_transform=_capture(r_grads))
    r_params, _, r_metrics = r_step(
        rp, r_opt.init(rp), {k: jnp.asarray(v) for k, v in batch.items()})

    model = Model(cfg)
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    sp = sharding.shard_tree(
        tp, sharding.param_shardings(model.param_shapes(), mesh))
    opt = AdamW(learning_rate=lr, eps=eps)
    step = make_train_step(model, opt, chunk_q=8,
                           shard_ctx={"mesh": mesh, "dp": ("data",)},
                           grad_transform=_capture(t_grads))
    params, state, metrics = step(sp, opt.init(sp), batch)

    # the port's unsharded microbatches=2 step
    u_grads = []
    unsharded = make_train_step(model, opt, chunk_q=8, microbatches=2,
                                grad_transform=_capture(u_grads),
                                device="cpu")
    p_u, state_u, m_u = unsharded(tp, opt.init(tp), batch)
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[name]), float(m_u[name]),
                                   **TOL)
    for got, want in ((t_grads[0], u_grads[0]), (state.mu, state_u.mu),
                      (state.nu, state_u.nu)):
        for a, b in zip(tree_leaves(sharding.gather_tree(got, "cpu")),
                        tree_leaves(want)):
            torch.testing.assert_close(a, b, **TOL)
    params_close(tree_leaves(sharding.gather_tree(params, "cpu")),
                 tree_leaves(p_u), tree_leaves(u_grads[0]),
                 float(m_u["grad_norm"]), lr, eps)
    for a, b in zip(tree_leaves(params, sharding.is_sharded),
                    tree_leaves(sp, sharding.is_sharded)):
        assert a.placement == b.placement

    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[name]),
                                   float(r_metrics[name]), **TOL)
    got_g = tree_leaves(sharding.gather_tree(t_grads[0], "cpu"))
    want_g = jax.tree.leaves(r_grads[0])
    assert len(got_g) == len(want_g)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    params_close([t.float().numpy() for t in
                  tree_leaves(sharding.gather_tree(params, "cpu"))],
                 jax.tree.leaves(r_params), want_g,
                 float(r_metrics["grad_norm"]), lr, eps)


@pytest.mark.parametrize("arch", ARCH_FILES[0])
def test_sharded_step_matches_reference_microbatched_step(arch):
    check_against_reference(arch)
