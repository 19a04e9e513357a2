"""The port's DLRM forward against the reference on copied parameters
(`convert.params_from_jax`), module by module and end to end, at the smoke
size of dlrm-m1 (6 tables, d=16) and a width where the reference scans
features (F > 8). Tolerance: probabilities, logits and NE within 1e-5
(fp32 throughout, summation orders differ).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import dlrm as jdlrm
from repro.core.embedding import EmbeddingBagCollection as JEBC
from repro.core.interaction import interact as jinteract
from repro.nn.params import init_params as jinit
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import dlrm
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.core.interaction import interact, interaction_dim
from repro_torch.data.synthetic import make_dlrm_batch

TOL = {"rtol": 1e-5, "atol": 1e-5}


def _wide(cfg):
    """Smoke dims but 10 tables, so the reference's lookup takes its
    scan-over-features branch (F > 8) like full dlrm-m1 (F = 30)."""
    return dataclasses.replace(
        cfg, n_sparse_features=10, hash_sizes=cfg.hash_sizes + (61,) * 4,
        mean_lookups=cfg.mean_lookups + (6,) * 4)


def _setup(wide):
    cfg, jcfg = get_smoke_config("dlrm-m1"), jget_smoke("dlrm-m1")
    if wide:
        cfg, jcfg = _wide(cfg), _wide(jcfg)
    jebc = JEBC.build(jcfg, n_shards=1, strategy="replicated")
    jparams = jinit(jdlrm.dlrm_param_specs(jcfg, jebc),
                    jax.random.PRNGKey(3))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    raw = make_dlrm_batch(cfg, 12, step=1, zipf_alpha=1.05)
    idx = ebc.offset_indices(raw["idx"])
    jbatch = {"dense": jnp.asarray(raw["dense"]), "idx": jnp.asarray(idx),
              "label": jnp.asarray(raw["label"])}
    batch = {"dense": torch.from_numpy(raw["dense"]),
             "idx": torch.from_numpy(idx),
             "label": torch.from_numpy(raw["label"])}
    return cfg, jcfg, ebc, jebc, params, jparams, batch, jbatch


@pytest.mark.parametrize("wide", [False, True])
def test_forward_probs_and_ne_match_reference(wide):
    cfg, jcfg, ebc, jebc, params, jparams, batch, jbatch = _setup(wide)
    want = np.asarray(jdlrm.dlrm_forward(jparams, jbatch, jcfg, jebc))
    with torch.no_grad():
        got = dlrm.dlrm_forward(params, batch, cfg, ebc)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(torch.sigmoid(got).numpy(),
                               np.asarray(jax.nn.sigmoid(want)), **TOL)
    ne = dlrm.normalized_entropy(got, batch["label"])
    jne = jdlrm.normalized_entropy(jnp.asarray(want), jbatch["label"])
    np.testing.assert_allclose(float(ne), float(jne), **TOL)
    np.testing.assert_allclose(float(dlrm._bce(got, batch["label"])),
                               float(jdlrm._bce(jnp.asarray(want),
                                                jbatch["label"])), **TOL)


@pytest.mark.parametrize("wide", [False, True])
def test_lookup_matches_reference(wide):
    cfg, jcfg, ebc, jebc, params, jparams, batch, jbatch = _setup(wide)
    want = np.asarray(jebc.lookup(jparams["emb"], jbatch["idx"]))
    got = ebc.lookup(params["emb"], batch["idx"]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_interaction_matches_reference():
    rng = np.random.RandomState(4)
    bot = rng.randn(6, 16).astype(np.float32)
    pooled = rng.randn(6, 9, 16).astype(np.float32)
    for kind in ("dot", "cat"):
        got = interact(torch.from_numpy(bot), torch.from_numpy(pooled), kind)
        want = np.asarray(jinteract(jnp.asarray(bot), jnp.asarray(pooled),
                                    kind))
        assert got.shape[1] == interaction_dim(9, 16, kind)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_param_specs_match_reference_layout():
    cfg = get_smoke_config("dlrm-m1")
    jcfg = jget_smoke("dlrm-m1")
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    jebc = JEBC.build(jcfg, n_shards=1, strategy="replicated")
    spec = dlrm.dlrm_param_specs(cfg, ebc)
    jspec = jdlrm.dlrm_param_specs(jcfg, jebc)
    for part in ("bottom", "top"):
        assert len(spec[part]) == len(jspec[part])
        for a, b in zip(spec[part], jspec[part]):
            assert {k: v.shape for k, v in a.items()} == \
                {k: v.shape for k, v in b.items()}
            assert {k: v.init for k, v in a.items()} == \
                {k: v.init for k, v in b.items()}
    assert spec["emb"]["mega"].shape == jspec["emb"]["mega"].shape
    assert spec["emb"]["mega"].scale == pytest.approx(
        jspec["emb"]["mega"].scale)


def test_init_params_is_seeded_and_follows_the_init_rules():
    cfg = get_smoke_config("dlrm-m1")
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    a = dlrm.init_dlrm_params(cfg, ebc, 5, torch.device("cpu"))
    b = dlrm.init_dlrm_params(cfg, ebc, 5, torch.device("cpu"))
    c = dlrm.init_dlrm_params(cfg, ebc, 6, torch.device("cpu"))
    assert torch.equal(a["emb"]["mega"], b["emb"]["mega"])
    assert not torch.equal(a["emb"]["mega"], c["emb"]["mega"])
    for layer in a["bottom"] + a["top"]:
        assert not layer["b"].any()                  # zeros
    w = a["bottom"][0]["w"]                          # fan_in: std 1/sqrt(in)
    assert w.shape == (cfg.n_dense_features, cfg.bottom_mlp[0])
    assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1) < 0.15
    mega = a["emb"]["mega"]                          # normal: std 1/sqrt(d)
    assert abs(float(mega.std()) * np.sqrt(cfg.embed_dim) - 1) < 0.05
