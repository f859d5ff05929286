"""Shared fixtures of the model-stack parity tests (``test_torch_models``,
``test_torch_generate``): one set of weights for both packages.

The reference initializes a reduced configuration; its gates, norms and
biases (zeros or ones at init, which would leave cross-attention and the
QKV biases untested) are perturbed with numpy noise from a seed; the
port gets the same numbers through ``convert.model_params_from_numpy``.
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import Model as RefModel
from repro_torch import convert
from repro_torch.configs import get_config, reduced

# leaves that init to constants: perturbed so that each one matters
_PERTURBED = ("gate", "ln", "ln_kv", "final_norm", "q_norm", "k_norm",
              "bq", "bk", "bv",
              # the recurrent slots' norms, biases, mixes and decay base
              "ln_w", "ln_b", "gn_w", "gn_b", "conv_b", "D", "w0",
              "mu_r", "mu_k", "mu_v", "mu_g", "mu_w")


def _perturb(tree, rng):
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out[name] = _perturb(value, rng)
            continue
        value = np.asarray(value, np.float32)
        if name in _PERTURBED:
            value = value + 0.3 * rng.standard_normal(value.shape).astype(
                np.float32)
        out[name] = value
    return out


def weights(arch, seed=1):
    """(reference config, port config, reference params as jax arrays,
    port params on the CPU), the same numbers in both."""
    rcfg = ref_reduced(ref_get_config(arch))
    cfg = reduced(get_config(arch))
    tree = jax.tree.map(np.asarray, RefModel(rcfg).init(
        jax.random.PRNGKey(seed)))
    tree = _perturb(tree, np.random.default_rng(seed))
    ref = jax.tree.map(jnp.asarray, tree)
    return rcfg, cfg, ref, convert.model_params_from_numpy(tree, device="cpu")


def tokens(cfg, B, S, seed=2):
    """(B, S) int32 token ids and, for the VLM, (B, I, D) float32 image
    embeddings (else None), as numpy."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(2, cfg.vocab_size, size=(B, S)).astype(np.int32)
    img = None
    if cfg.family == "vlm":
        img = (rng.standard_normal((B, cfg.num_image_tokens, cfg.d_model))
               * 0.02).astype(np.float32)
    return tok, img
