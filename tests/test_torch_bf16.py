"""``tpu.compute_dtype: bfloat16`` in the port against kge_tpu on data/toy.

Training calls embed in bf16 (``LookupEmbedder._cast``, after dropout);
parameters, gradients and optimizer state stay float32, losses compute in
float32, evaluation scores in float32. Held here:

- the bf16-cast embeddings equal kge_tpu's bit for bit, and evaluation
  embeddings stay float32;
- the first step's loss under bf16 within 1e-2 relative of kge_tpu's,
  from the same initial weights, and the first epoch's avg_loss too:
  ComplEx (shared kl through K1's plain version, dense and row-sparse),
  DistMult (KvsAll, bce), TransE (margin ranking, ``triple`` scoring),
  CompGCN + TransE, and every other scorer and encoder (CP, SimplE,
  RESCAL, RelationalTucker3 and the reciprocal Transformer by 1vsAll,
  TransH, R-GCN, RAGAT, W-GCN with ConvE; RotatE's first step). bf16
  keeps 8 bits of mantissa, and XLA's ``xla_allow_excess_precision``
  skips roundings of bf16 intermediates that torch makes, so the runs
  are held loosely. The largest gaps measured: first step 3.9e-3
  (RotatE), then 3.5e-4 (CompGCN + TransE), 2.1e-4 (RESCAL), 1.7e-4
  (CP); epoch 2.5e-3 (TransH), 9.0e-4 (CompGCN + TransE);
- reciprocal ConvE and CompGCN with ccorr: kge_tpu refuses bf16 there
  (``lax.conv_general_dilated`` takes one dtype, ``jnp.fft.rfft`` no
  bf16), where the port promotes to float32 as ``jnp``'s arithmetic does.
  With tables rounded to bf16 beforehand the cast is exact, so the port's
  bf16 step equals kge_tpu's float32 step on those tables (rtol 1e-6);
- K1's wrapper on bf16 operands, forward and gradients, against
  kge_tpu's ``shared_ce_loss`` in interpret mode: the loss rtol 1e-6
  (both cast the same bf16 values to float32), the gradients come back in
  bf16 and agree to one bf16 rounding (rtol 2^-7, atol 1e-6);
- params and ``opt_state`` stay float32, and a bf16 run's checkpoint
  resumes in kge_tpu under bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kge_tpu import Config as JaxConfig, Dataset as JaxDataset
from kge_tpu.models.api import Ctx as JaxCtx
from kge_tpu.ops.pallas.negsamp_loss import shared_ce_loss as jax_shared_ce
from kge_tpu.train.job import Job as JaxJob
from kge_tpu.train.train import TrainingJob as JaxTrainingJob
from kge_tpu.utils.io import load_checkpoint as jax_load_checkpoint
from kge_tpu_torch import Config, Dataset
from kge_tpu_torch.models import Ctx
from kge_tpu_torch.ops.negsamp_loss import shared_ce_loss
from kge_tpu_torch.train.train import TrainingJob
from kge_tpu_torch.utils.params import tree_leaves
from tests import test_torch_model_zoo_train as zoo
from tests import test_torch_rgnn_train as rgnn
from tests.test_torch_train import TOY, first_batch_loss, record_epochs

torch.set_num_threads(1)

BF16 = {"tpu.compute_dtype": "bfloat16", "train.max_epochs": 1}

#: name -> (model, reciprocal?, options), as tests/test_torch_model_zoo_train
CASES = {
    "complex-shared-kl-fused": (
        "complex", False, {"train.type": "negative_sampling",
                           "train.loss": "kl",
                           "negative_sampling.num_samples.s": 7,
                           "negative_sampling.num_samples.o": 7,
                           "negative_sampling.shared": True,
                           "negative_sampling.implementation": "batch",
                           "tpu.fused_negsamp_loss": "always",
                           "train.optimizer.default.args.lr": 0.2}),
    "complex-shared-kl-fused-sparse": (
        "complex", False, {"train.type": "negative_sampling",
                           "train.loss": "kl",
                           "negative_sampling.num_samples.s": 7,
                           "negative_sampling.num_samples.o": 7,
                           "negative_sampling.shared": True,
                           "negative_sampling.implementation": "batch",
                           "tpu.fused_negsamp_loss": "always",
                           "tpu.sparse_updates": "always",
                           "train.optimizer.default.args.lr": 0.2}),
    "distmult-kvsall-bce": (
        "distmult", False, {"train.type": "KvsAll", "train.loss": "bce",
                            "KvsAll.label_smoothing": 0.1}),
    "transe-margin-triple": zoo.CASES["transe-margin-triple"],
}


def _jobs(make_config, cls_pair, model_args, options, tmp_path):
    (jax_cls, jax_job_cls), (port_cls, port_job_cls) = cls_pair
    jconfig = make_config(jax_cls, *model_args, options, str(tmp_path / "jax"))
    jax_run = jax_job_cls.create(jconfig, JaxDataset.create(jconfig, TOY))
    pconfig = make_config(port_cls, *model_args, options,
                          str(tmp_path / "port"))
    port_run = port_job_cls.create(pconfig, Dataset.create(pconfig, TOY))
    port_run.model.load_params(
        jax.tree_util.tree_map(np.asarray, jax_run.params))
    return jax_run, port_run


CLASSES = ((JaxConfig, JaxTrainingJob), (Config, TrainingJob))


def zoo_jobs(name, tmp_path, **overrides):
    model, reciprocal, options = CASES[name]
    return _jobs(zoo.make_config, CLASSES, (model, reciprocal),
                 {**options, **BF16, **overrides}, tmp_path)


def test_cast_embeddings_equal_kge_tpu(tmp_path):
    """Training embeddings bf16 and bit for bit kge_tpu's (after dropout
    0), evaluation embeddings float32 and the table's own values."""
    jax_run, port_run = zoo_jobs("complex-shared-kl-fused", tmp_path)
    ids = np.random.default_rng(0).integers(
        0, port_run.dataset.num_entities(), 50)
    jemb = jax_run.model.get_s_embedder()
    pemb = port_run.model.get_s_embedder()
    want = jemb.embed(jax_run.params["entity_embedder"], jnp.asarray(ids),
                      JaxCtx(train=True))
    got = pemb.embed(torch.as_tensor(ids), Ctx(train=True))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    all_want = jemb.embed_all(jax_run.params["entity_embedder"],
                              JaxCtx(train=True))
    all_got = pemb.embed_all(Ctx(train=True))
    np.testing.assert_array_equal(all_got.detach().float().numpy(),
                                  np.asarray(all_want.astype(jnp.float32)))
    evaluated = pemb.embed(torch.as_tensor(ids), Ctx())
    assert evaluated.dtype == torch.float32
    np.testing.assert_array_equal(
        evaluated.detach().numpy(), port_run.model.params()[
            "entity_embedder"]["weights"][ids])


@pytest.mark.parametrize("name", list(CASES))
def test_first_step_loss_matches_kge_tpu(name, tmp_path):
    jax_run, port_run = zoo_jobs(name, tmp_path)
    want, got = record_epochs(jax_run), record_epochs(port_run)
    jax_run.run()
    port_run.run()
    np.testing.assert_allclose(first_batch_loss(port_run.config.folder),
                               first_batch_loss(jax_run.config.folder),
                               rtol=1e-2)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-2)
    if name.endswith("sparse"):
        assert len(port_run._sparse_paths) == 2


def test_compgcn_transe_first_step_matches_kge_tpu(tmp_path):
    """Toy CompGCN + TransE (examples/toy-transe-compgcn-train.yaml's
    training, two layers): the encoder reads bf16 embeddings and runs its
    layers in float32, as jnp's promotion against the layer weights
    does."""
    preset, options = rgnn.CASES["compgcn-transe-margin"]
    jax_run, port_run = _jobs(rgnn.make_config, CLASSES, (preset,),
                              {**options, **BF16}, tmp_path)
    want, got = record_epochs(jax_run), record_epochs(port_run)
    jax_run.run()
    port_run.run()
    np.testing.assert_allclose(first_batch_loss(port_run.config.folder),
                               first_batch_loss(jax_run.config.folder),
                               rtol=1e-2)
    np.testing.assert_allclose(got, want, rtol=1e-2)


#: every other scorer and encoder under bf16 against kge_tpu (first step
#: and epoch within 1e-2, as above): (make_config, model arguments,
#: options)
OTHERS = {
    **{name: (zoo.make_config, zoo.CASES[name][:2], zoo.CASES[name][2])
       for name in ("relational-tucker3-1vsall",
                    "reciprocal-transformer-1vsall")},
    **{name: (zoo.make_config, (model, False), {
        "train.type": "1vsAll", "train.loss": "kl",
        "lookup_embedder.dim": dim})
       for name, model, dim in (("cp-1vsall", "cp", 16),
                                ("simple-1vsall", "simple", 16),
                                ("rescal-1vsall", "rescal", 4))},
    "transh-negative-sampling": (zoo.make_config, ("transh", False), {
        "train.type": "negative_sampling", "train.loss": "bce"}),
    **{name: (rgnn.make_config, rgnn.CASES[name][:1], rgnn.CASES[name][1])
       for name in ("rgcn-distmult-graph-sampling",
                    "ragat-distmult-1vsall", "wgcn-conve-kvsall")},
}


@pytest.mark.parametrize("name", list(OTHERS))
def test_other_models_first_step_match_kge_tpu(name, tmp_path):
    make_config, model_args, options = OTHERS[name]
    jax_run, port_run = _jobs(make_config, CLASSES, model_args,
                              {**options, **BF16}, tmp_path)
    want, got = record_epochs(jax_run), record_epochs(port_run)
    jax_run.run()
    port_run.run()
    np.testing.assert_allclose(first_batch_loss(port_run.config.folder),
                               first_batch_loss(jax_run.config.folder),
                               rtol=1e-2)
    np.testing.assert_allclose(got, want, rtol=1e-2)


def test_rotate_first_step_matches_kge_tpu(tmp_path):
    """RotatE's first step under bf16 within 1e-2 of kge_tpu's. Its
    modulus sqrt(re^2 + im^2) has no epsilon: under bf16 a difference of
    exactly 0 is common and its gradient 0 * inf is NaN, so a run goes NaN
    after some steps in either package, at a step that bf16 rounding
    decides (from these weights kge_tpu's at its tenth, the port's later;
    from the port's own, the port's too)."""
    jax_run, port_run = _jobs(zoo.make_config, CLASSES, ("rotate", False),
                              {"train.type": "negative_sampling",
                               "train.abort_on_nan": False, **BF16},
                              tmp_path)
    jax_run.run()
    port_run.run()
    np.testing.assert_allclose(first_batch_loss(port_run.config.folder),
                               first_batch_loss(jax_run.config.folder),
                               rtol=1e-2)


def _round_tables_to_bf16(params):
    """The params tree (numpy) with every embedding table rounded to bf16
    and stored as float32: the bf16 cast of these tables is exact."""
    def rounded(path, leaf):
        if getattr(path[-1], "key", None) == "weights":
            leaf = jnp.asarray(leaf).astype(jnp.bfloat16).astype(jnp.float32)
        return np.asarray(leaf)
    return jax.tree_util.tree_map_with_path(rounded, params)


#: where kge_tpu refuses bf16: (make_config, model arguments, options,
#: kge_tpu's error and its message)
REFUSED = {
    # lax.conv_general_dilated takes one dtype
    "reciprocal-conve": (
        zoo.make_config, zoo.CASES["reciprocal-conve-kvsall-adam"][:2],
        zoo.CASES["reciprocal-conve-kvsall-adam"][2], TypeError,
        "same dtypes"),
    # jnp.fft.rfft of the bf16 neighbour rows (ccorr), before ConvE
    "compgcn-ccorr-conve": (
        rgnn.make_config, rgnn.CASES["compgcn-conve-kvsall"][:1],
        rgnn.CASES["compgcn-conve-kvsall"][1], ValueError, "RFFT input"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_promotes_where_kge_tpu_refuses(name, tmp_path):
    make_config, model_args, options, error, message = REFUSED[name]
    options = {**options, "train.max_epochs": 1}
    jconfig = make_config(JaxConfig, *model_args, {**options, **BF16},
                          str(tmp_path / "jax-bf16"))
    jax_bf16 = JaxTrainingJob.create(jconfig, JaxDataset.create(jconfig, TOY))
    with pytest.raises(error, match=message):
        jax_bf16.run()
    # kge_tpu in float32 on bf16-rounded tables: the port's bf16 run casts
    # those tables exactly and computes the rest in float32
    jconfig = make_config(JaxConfig, *model_args, options,
                          str(tmp_path / "jax"))
    jax_run = JaxTrainingJob.create(jconfig, JaxDataset.create(jconfig, TOY))
    params = _round_tables_to_bf16(jax_run.params)
    jax_run.params = jax.tree_util.tree_map(jnp.asarray, params)
    pconfig = make_config(Config, *model_args, {**options, **BF16},
                          str(tmp_path / "port"))
    port_run = TrainingJob.create(pconfig, Dataset.create(pconfig, TOY))
    port_run.model.load_params(params)
    jax_run.run()
    port_run.run()
    np.testing.assert_allclose(first_batch_loss(port_run.config.folder),
                               first_batch_loss(jax_run.config.folder),
                               rtol=1e-6)


def test_k1_bf16_operands_match_kge_tpu():
    rng = np.random.default_rng(7)
    B, N, D = 24, 9, 16
    q = rng.normal(size=(B, D)).astype(np.float32)
    cand = rng.normal(size=(N, D)).astype(np.float32)
    pos = rng.normal(size=B).astype(np.float32)
    counts = rng.integers(0, 3, size=(B, N)).astype(np.float32)
    w = (rng.random(B) < 0.9).astype(np.float32)
    jq, jc, jp = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, cand, pos))

    def jax_loss(a, b, c):
        return jax_shared_ce(a, b, c, jnp.asarray(counts), jnp.asarray(w),
                             True)

    want, grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(jq, jc, jp)
    tq, tc, tp = (torch.from_numpy(np.asarray(x.astype(jnp.float32)))
                  .to(torch.bfloat16).requires_grad_()
                  for x in (jq, jc, jp))
    got = shared_ce_loss(tq, tc, tp, torch.from_numpy(counts),
                         torch.from_numpy(w))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for t, g in zip((tq, tc, tp), grads):
        assert g.dtype == jnp.bfloat16 and t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(g.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-6)


def test_state_stays_float32_and_resumes_in_kge_tpu(tmp_path):
    """A bf16 run with Adam: every parameter, gradient-free table and
    ``opt_state`` leaf float32 in the checkpoint; kge_tpu resumes it under
    bf16 for another epoch."""
    jax_run, port_run = zoo_jobs(
        "complex-shared-kl-fused", tmp_path,
        **{"train.optimizer.default.type": "Adam",
           "train.optimizer.default.args.lr": 0.01})
    port_run.run()
    assert all(p.dtype == torch.float32 for p in port_run.model.parameters())
    checkpoint = jax_load_checkpoint(port_run.config.checkpoint_file(1))
    leaves = tree_leaves(checkpoint["opt_state"])
    assert leaves and all(np.asarray(x).dtype in (np.float32, np.int32)
                          for x in leaves)
    assert all(np.asarray(x).dtype == np.float32
               for x in jax.tree_util.tree_leaves(checkpoint["model"]))
    checkpoint.pop("folder")
    config = JaxConfig.create_from(checkpoint)
    assert config.get("tpu.compute_dtype") == "bfloat16"
    config.set("train.max_epochs", 2)
    job = JaxJob.create_from(checkpoint, new_config=config,
                             dataset=JaxDataset.create(config, TOY))
    assert job.epoch == 1
    assert np.isfinite(job.run()["avg_loss"]) and job.epoch == 2
