"""The port's vision family (``models/cnn.py``, ``models/resnet.py``, the
dp ``Trainer`` on them, ``cli/train_mnist.py``, ``cli/train_cifar_resnet.py``)
against the JAX package's, on the CPU.

Full-width CNN and ResNet-18: the same seed gives the same weights bit for
bit, the logits agree within ``LOGITS_TOL``. A narrow ResNet
(:class:`NarrowResNet`: one block a stage, ``STAGES`` overridden in both
packages; the JAX init fixes the stem at 64 channels and ``fc`` at 512
features, so the first stage's identity shortcut stays 64 wide and the
last stage 512) on 8x8 images gives the gradients. The dp runs take two
updates at a small learning rate: batch statistics over few values make a
ResNet's trajectory chaotic (8 rows a rank at lr 0.05 part the two
packages by 15% at the fourth update). At 16x16 images the JAX package's
f32 gradients of the first stage are 1% of max |g| off an f64 computation
of the same step (its reductions of the batch statistics over 8192 values;
the port's are 1e-6 off), so the images stay 8x8. One module-scoped
gloo spawn of two ranks runs the dp cases (the narrow ResNet's ``Trainer``
under ``ring`` and ``xla``, its dp steps' synced gradients and the eval's
logits, the CNN's ``Trainer`` under ``plateau``) while the JAX references
compute; the tests hold them to ``test_trainer_dp4_ring_tracks_the_jax_
trainer``'s bounds."""

import gzip
import logging
import os
import struct

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

from dsml_tpu.models.cnn import CNN as JaxCNN
from dsml_tpu.models.resnet import ResNet18 as JaxResNet18
from dsml_tpu_torch.checkpoint import CheckpointManager
from dsml_tpu_torch.cli import train_cifar_resnet, train_mnist
from dsml_tpu_torch.models import CNN, ResNet18
from dsml_tpu_torch.models.common import same_conv
from dsml_tpu_torch.models.convert import params_from_jax
from dsml_tpu_torch.models.resnet import BN_EPS
from dsml_tpu_torch.parallel.dp import batch_stats_scope, make_dp_train_step, rank_rows
from dsml_tpu_torch.parallel.mesh import data_mesh
from dsml_tpu_torch.trainer import TrainConfig, Trainer
from dsml_tpu_torch.utils import data as tdata

LOGITS_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = 1e-4  # of max |g|
# tests/test_trainer.py::test_ring_and_xla_gradient_sync_agree
TRAINER_LOSS_RTOL, TRAINER_PARAM_TOL = 1e-4, dict(rtol=1e-3, atol=1e-5)
NARROW_DATA = dict(n=72, features=8 * 8 * 3, classes=10, seed=5, image_shape=(8, 8, 3))
RESNET_CFG = dict(epochs=1, batch_size=32, lr=0.002, optimizer="momentum", seed=7)
CNN_KW = dict(conv_features=(4, 8), fc_width=16)
CNN_DATA = dict(n=320, features=28 * 28, classes=10, seed=1)
PLATEAU_CFG = dict(epochs=4, batch_size=32, lr=0.2, optimizer="momentum", lr_schedule="plateau",
                   plateau_patience=1, seed=2, algorithm="ring")


class NarrowResNet(ResNet18):
    STAGES = (64, 16, 16, 512)
    BLOCKS_PER_STAGE = 1


class JaxNarrowResNet(JaxResNet18):
    STAGES = (64, 16, 16, 512)
    BLOCKS_PER_STAGE = 1


def _narrow_batch(n=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 8, 8, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops oversubscribe the cores under the suite's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- rank worker (spawned; module level so the children import it) ---------------------


def _dp2_worker(rank, tmp):
    torch.set_num_threads(1)
    mesh = data_mesh(2, rank, os.path.join(tmp, "rendezvous"), "cpu")
    group = mesh.group("dp")
    res = {}
    data = tdata.synthetic_classification(**NARROW_DATA)
    for alg in ("ring", "xla"):
        state, history, acc = Trainer(NarrowResNet(device="cpu"),
                                      TrainConfig(algorithm=alg, **RESNET_CFG), mesh=mesh).train(data)
        res[f"trainer_{alg}"] = {"state": state, "history": history, "acc": acc}
    # one synced step's gradients from the same weights (SGD at lr 0 keeps them in p.grad)
    x, y = (torch.from_numpy(t) for t in _narrow_batch())
    for alg in ("ring", "xla"):
        model = NarrowResNet(device="cpu").init(3)
        step = make_dp_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0), mesh, alg)
        res[f"loss_{alg}"] = float(step(x, y))
        res[f"grads_{alg}"] = {n: p.grad.clone() for n, p in model.named_parameters()}
    with torch.no_grad(), batch_stats_scope(model, group):
        res["eval_logits"] = model.apply(rank_rows(x, group))
    cnn = CNN(device="cpu", **CNN_KW)
    cfg = TrainConfig(checkpoint_dir=os.path.join(tmp, "cnn_plateau"), **PLATEAU_CFG)
    state, history, acc = Trainer(cnn, cfg, mesh=mesh).train(
        tdata.synthetic_classification(**CNN_DATA))
    res["trainer_plateau"] = {"state": state, "history": history, "acc": acc}
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    mesh.close()
    dist.destroy_process_group()


def _jax_trainer(model, cfg, data, devices, **ck):
    import jax

    from dsml_tpu.parallel.mesh import data_mesh as jax_data_mesh
    from dsml_tpu.trainer import TrainConfig as JaxTrainConfig
    from dsml_tpu.trainer import Trainer as JaxTrainer

    params, history, acc = JaxTrainer(model, JaxTrainConfig(**cfg, **ck),
                                      mesh=jax_data_mesh(devices=devices[:2])).train(data)
    return params_from_jax(jax.tree.map(np.asarray, params)), history, acc


def _jax_references(devices, tmp):
    """The JAX runs, three at a time in threads (XLA compiles outside the
    GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    from dsml_tpu.utils.data import synthetic_classification

    data = synthetic_classification(**NARROW_DATA)
    with ThreadPoolExecutor(3) as pool:
        runs = {f"trainer_{alg}": pool.submit(_jax_trainer, JaxNarrowResNet(),
                                              dict(algorithm=alg, **RESNET_CFG), data, devices)
                for alg in ("ring", "xla")}
        runs["trainer_plateau"] = pool.submit(
            _jax_trainer, JaxCNN(**CNN_KW), PLATEAU_CFG, synthetic_classification(**CNN_DATA),
            devices, checkpoint_dir=os.path.join(tmp, "jax_cnn_plateau"))
        model = JaxNarrowResNet()
        out = {"eval_logits": np.asarray(jax.jit(model.apply)(model.init(3), _narrow_batch()[0]))}
        out.update({k: f.result() for k, f in runs.items()})
    return out


@pytest.fixture(scope="module")
def dp2(tmp_path_factory, devices8):
    tmp = str(tmp_path_factory.mktemp("vision_dp2"))
    ctx = mp.start_processes(_dp2_worker, args=(tmp,), nprocs=2, join=False, start_method="spawn")
    try:
        want = _jax_references(devices8, tmp)
    finally:
        while not ctx.join():
            pass
    return tmp, [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)], want


# ---- one device -----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cnn", "resnet18"])
def test_same_seed_same_weights_as_jax(name):
    """Full width: ``init(seed)`` draws the JAX package's weights bit for
    bit, under the same names and shapes."""
    import jax

    jmodel, tmodel = (JaxCNN(), CNN) if name == "cnn" else (JaxResNet18(), ResNet18)
    want = params_from_jax(jax.tree.map(np.asarray, jmodel.init(11)))
    got = tmodel(device="cpu").init(11).state_dict()
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.dtype == torch.float32 and torch.equal(t, want[k]), k


def test_param_counts_in_the_jax_tests_ranges():
    """``tests/test_models.py``'s ranges: the CNN 100k–2M, ResNet-18
    10.5M–12M."""
    n_cnn = sum(p.numel() for p in CNN(device="cpu").parameters())
    n_resnet = sum(p.numel() for p in ResNet18(device="cpu").parameters())
    assert 100_000 < n_cnn < 2_000_000
    assert 10_500_000 < n_resnet < 12_000_000, n_resnet


@pytest.fixture(scope="module")
def mnist_rows():
    data = tdata.load_mnist()
    return data.test_x[:4], data.test_y[:4]


@pytest.mark.parametrize("name", ["cnn", "resnet18"])
def test_full_width_logits_match_jax(name, mnist_rows):
    """The same weights on 4 MNIST rows (flat, as the data loader gives
    them) and 2 CIFAR-shaped NHWC images: logits within ``LOGITS_TOL``."""
    import jax

    if name == "cnn":
        jmodel, model, x = JaxCNN(), CNN(device="cpu"), mnist_rows[0]
    else:
        jmodel, model = JaxResNet18(), ResNet18(device="cpu")
        x = np.random.default_rng(4).random((2, 32, 32, 3)).astype(np.float32)
    params = jmodel.init(2)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    want = np.asarray(jax.jit(jmodel.apply)(params, x))
    with torch.no_grad():
        got = model.apply(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **LOGITS_TOL)
    if name == "cnn":  # the correct counts too
        y = torch.from_numpy(mnist_rows[1])
        assert int(model.accuracy_count(torch.from_numpy(x), y)) == int(
            jmodel.accuracy_count(params, x, mnist_rows[1]))


def test_cnn_flattens_the_pooled_map_in_nhwc_order(mnist_rows):
    """The JAX CNN flattens its pooled [B, 7, 7, 64] map NHWC: the port
    matches it, and an NCHW flatten of the same map would not."""
    import jax

    jmodel, model = JaxCNN(), CNN(device="cpu")
    params = jmodel.init(0)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    x = torch.from_numpy(mnist_rows[0])
    want = np.asarray(jax.jit(jmodel.apply)(params, mnist_rows[0]))
    with torch.no_grad():
        np.testing.assert_allclose(model.apply(x).numpy(), want, **LOGITS_TOL)
        h = x.reshape(-1, 28, 28, 1).permute(0, 3, 1, 2)
        for c in (model.conv1, model.conv2):
            h = F.max_pool2d(torch.relu(same_conv(h, c["w"]) + c["b"][:, None, None]), 2)
        nchw = torch.relu(h.reshape(h.shape[0], -1) @ model.fc1["w"] + model.fc1["b"])
        wrong = (nchw @ model.fc2["w"] + model.fc2["b"]).numpy()
    assert np.abs(wrong - want).max() > 1e-2


def test_stride2_same_conv_pads_zero_before_one_after():
    """XLA's ``padding="SAME"`` at stride 2 on an even input pads a 3x3
    conv (0, 1): ``same_conv`` matches ``lax.conv_general_dilated``, while
    ``F.conv2d(padding=1)`` samples other pixels; the 1x1 stride-2 ``down``
    conv pads nothing, the stride-1 3x3 (1, 1)."""
    from jax import lax

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for k, stride in ((3, 2), (1, 2), (3, 1)):
        w = rng.standard_normal((k, k, 4, 8)).astype(np.float32)
        want = np.asarray(lax.conv_general_dilated(x, w, (stride, stride), "SAME",
                                                   dimension_numbers=("NHWC", "HWIO", "NHWC")))
        got = same_conv(xt, torch.from_numpy(w), stride).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        if (k, stride) == (3, 2):
            sym = F.conv2d(xt, torch.from_numpy(w).permute(3, 2, 0, 1), stride=stride,
                           padding=1).permute(0, 2, 3, 1).numpy()
            assert sym.shape == want.shape and np.abs(sym - want).max() > 1.0


def test_resnet_init_draws_fc_before_the_stages():
    """The JAX dict literal draws ``fc`` right after the stem, before the
    stage loop: ``fc.w`` is the rng's second draw."""
    from dsml_tpu_torch.models.common import he_init

    rng = np.random.default_rng(5)
    he_init(rng, 3, 3, 3, 64, fan_in=27)
    want = he_init(rng, 512, 10, fan_in=512)
    model = ResNet18(device="cpu").init(5)
    assert torch.equal(model.fc["w"], want)


def test_batch_norm_is_batch_stat_with_population_variance():
    """Batch norm normalises by the batch's mean and its population
    variance (ddof 0), eps 1e-5, and keeps no running statistics: the same
    input gives the same output in eval mode."""
    model = NarrowResNet(device="cpu").init(0)
    bn = {"scale": torch.full((6,), 1.5), "bias": torch.full((6,), 0.25)}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 6, 3, 3)).astype(np.float32))
    xn = x.double().numpy()
    mean = xn.mean((0, 2, 3), keepdims=True)
    for ddof, same in ((0, True), (1, False)):
        var = xn.var((0, 2, 3), ddof=ddof, keepdims=True)
        want = (xn - mean) / np.sqrt(var + BN_EPS) * 1.5 + 0.25
        got = model._batch_norm(x, bn).double().numpy()
        assert np.allclose(got, want, rtol=1e-5, atol=1e-5) == same
    model.eval()
    assert torch.equal(model._batch_norm(x, bn), model._batch_norm(x, bn))
    assert not any(True for _ in model.buffers())


def test_narrow_resnet_gradients_match_jax():
    """The narrow ResNet (stride-2 SAME convs in three stages, the ``down``
    convs, the first stage's identity shortcut) at f32: loss and every
    gradient within ``GRAD_TOL`` of max |g|."""
    import jax

    jmodel = JaxNarrowResNet()
    params = jmodel.init(3)
    x, y = _narrow_batch()
    want_loss, want = jax.jit(jax.value_and_grad(jmodel.loss))(params, x, y)
    want = params_from_jax(jax.tree.map(np.asarray, want))
    model = NarrowResNet(device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    loss = model.loss(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for n, p in model.named_parameters():
        scale = max(want[n].abs().max().item(), 1e-30)
        assert (p.grad - want[n]).abs().max().item() <= GRAD_TOL * scale, n


# ---- dp = 2 over gloo -------------------------------------------------------------------


def _check_trainer(ranks, want, key):
    want_state, want_history, want_acc = want[key]
    for r in ranks:
        got = r[key]
        for g, w in zip(got["history"], want_history, strict=True):
            assert np.isclose(g["avg_loss"], w["avg_loss"], rtol=TRAINER_LOSS_RTOL), key
            assert abs(g["train_accuracy"] - w["train_accuracy"]) <= 2 / 64, key
        for k, t in got["state"].items():
            np.testing.assert_allclose(t.numpy(), want_state[k].numpy(), **TRAINER_PARAM_TOL,
                                       err_msg=f"{key} {k}")
        assert abs(got["acc"] - want_acc) <= 1 / 8 + 1e-9, key
    a, b = ([(h["avg_loss"], h["train_accuracy"]) for h in r[key]["history"]] for r in ranks)
    assert a == b and ranks[0][key]["acc"] == ranks[1][key]["acc"], key
    a, b = (r[key] for r in ranks)
    assert all(torch.equal(t, b["state"][k]) for k, t in a["state"].items()), key


@pytest.mark.parametrize("alg", ["ring", "xla"])
def test_narrow_resnet_trainer_dp2_tracks_the_jax_trainer(dp2, alg):
    """The port's ``Trainer`` at dp = 2 against the JAX ``Trainer`` on
    ``data_mesh(2)``: ``ring`` normalises each rank's rows (the JAX
    ``shard_map``), ``xla`` the global batch (the JAX jit); epoch loss
    rtol 1e-4, weights rtol 1e-3 / atol 1e-5, the eval accuracies, and the
    ranks bit for bit."""
    _, ranks, want = dp2
    _check_trainer(ranks, want, f"trainer_{alg}")


def test_dp_step_batch_statistics_by_sync(dp2):
    """One dp = 2 step of the narrow ResNet from the same weights: under
    ``xla`` the synced gradients are the single-device gradients of the
    global batch (statistics over all 32 rows); under ``ring`` the mean of
    each half's gradients normalised alone. The two differ."""
    _, ranks, _ = dp2
    x, y = (torch.from_numpy(t) for t in _narrow_batch())

    def grads(rows):
        model = NarrowResNet(device="cpu").init(3)
        loss = model.loss(x[rows], y[rows])
        loss.backward()
        return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}

    full_loss, full = grads(slice(0, 32))
    halves = [grads(slice(0, 16)), grads(slice(16, 32))]
    per_rank = {n: (halves[0][1][n] + halves[1][1][n]) / 2 for n in full}
    for r in ranks:
        for alg, want, loss in (("xla", full, full_loss),
                                ("ring", per_rank, (halves[0][0] + halves[1][0]) / 2)):
            assert abs(r[f"loss_{alg}"] - loss) <= 1e-5 * abs(loss), alg
            for n, g in r[f"grads_{alg}"].items():
                scale = max(want[n].abs().max().item(), 1e-30)
                assert (g - want[n]).abs().max().item() <= GRAD_TOL * scale, (alg, n)
    gap = max((ranks[0]["grads_xla"][n] - per_rank[n]).abs().max().item() for n in full)
    assert gap > 1e-3


def test_eval_at_dp2_normalises_over_the_global_batch(dp2):
    """The eval's forward at dp = 2 (``make_eval_step``'s scope): each rank's
    rows normalised with the whole batch's statistics, the JAX eval's plain
    jit over the global batch; logits within ``LOGITS_TOL``."""
    _, ranks, want = dp2
    got = torch.cat([r["eval_logits"] for r in ranks]).numpy()
    np.testing.assert_allclose(got, want["eval_logits"], **LOGITS_TOL)


def test_cnn_plateau_trainer_dp2_tracks_the_jax_trainer(dp2):
    """The CNN's ``Trainer`` with ``lr_schedule="plateau"`` (patience 1, a
    loss that stops improving) at dp = 2 against the JAX ``Trainer``: the
    trainer bounds, and the final plateau state of each package's last
    checkpoint (the scale decayed, equal exactly; the counts equal; the best
    window mean within the loss bound)."""
    tmp, ranks, want = dp2
    _check_trainer(ranks, want, "trainer_plateau")
    states = []
    for d in ("cnn_plateau", "jax_cnn_plateau"):
        with CheckpointManager(os.path.join(tmp, d)) as m:
            states.append(m.restore()["opt_state"][1])
    got, ref = states
    assert float(ref["scale"]) < 1.0
    for k in ("scale", "plateau_count", "cooldown_count", "count"):
        assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(ref[k])), k
    assert np.isclose(float(got["best_value"]), float(ref["best_value"]), rtol=TRAINER_LOSS_RTOL)


# ---- CIFAR-10 records and the entry points ------------------------------------------------


def _forge_cifar(path, n, seed):
    rng = np.random.default_rng(seed)
    raw = np.concatenate([rng.integers(0, 10, (n, 1)), rng.integers(0, 256, (n, 3072))], 1)
    raw.astype(np.uint8).tofile(path)


def test_load_cifar10_reads_what_the_jax_loader_reads(tmp_path, caplog):
    """Forged 3073-byte records: the same arrays as the JAX example's
    loader (CHW planar → NHWC / 255), bit for bit; without the files both
    fall back to the same synthetic workload, with a warning."""
    import examples.train_cifar_resnet as jexample

    for i in (1, 2):
        _forge_cifar(tmp_path / f"data_batch_{i}.bin", 5, i)
    _forge_cifar(tmp_path / "test_batch.bin", 3, 9)
    got = train_cifar_resnet.load_cifar10(str(tmp_path), 0, 0)
    want = jexample.load_cifar10(str(tmp_path), 0, 0)
    for k in ("train_x", "train_y", "test_x", "test_y"):
        a, b = getattr(got, k), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k
    assert got.train_x.shape == (10, 32, 32, 3)
    raw = np.fromfile(tmp_path / "test_batch.bin", np.uint8).reshape(-1, 3073)
    assert got.test_x[1, 2, 3, 1] == np.float32(raw[1, 1 + 1024 + 2 * 32 + 3]) / np.float32(255)
    handler = _Lines()
    logging.getLogger("dsml.cifar").addHandler(handler)
    try:
        synth = train_cifar_resnet.load_cifar10(str(tmp_path / "none"), 40, 3)
    finally:
        logging.getLogger("dsml.cifar").removeHandler(handler)
    want = jexample.load_cifar10(str(tmp_path / "none"), 40, 3)
    assert any("no CIFAR-10 binaries" in m for m in handler.lines)
    assert np.array_equal(synth.train_x, np.asarray(want.train_x))
    assert synth.train_x.shape == (36, 32, 32, 3)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _idx(path, arr, magic):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", magic) + b"".join(struct.pack(">I", d) for d in arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.fixture(scope="module")
def small_mnist(tmp_path_factory):
    """The first 2100 t10k images of the repo's MNIST: the loader's split
    leaves 100 to train on (500 with its shifts) and 2000 to test."""
    d = tmp_path_factory.mktemp("mnist_small")
    for name, magic in (("t10k-images-idx3-ubyte.gz", 2051), ("t10k-labels-idx1-ubyte.gz", 2049)):
        _idx(d / name, tdata._read_idx(os.path.join("data", "mnist", name))[:2100], magic)
    return str(d)


MNIST_CLI = ["--model", "cnn", "--device", "cpu", "--epochs", "1", "--batch_size", "50",
             "--lr", "0.05", "--optimizer", "momentum"]


@pytest.fixture(scope="module")
def mnist_cli_one_device(small_mnist):
    return train_mnist.train(train_mnist.MNISTConfig.parse_args(
        MNIST_CLI + ["--data_dir", small_mnist]), train_mnist.mnist_model, train_mnist.mnist_data)


@pytest.mark.parametrize("dp", [1, 2])
def test_train_mnist_cnn_cli_on_cpu(small_mnist, mnist_cli_one_device, dp):
    """``cli.train_mnist --model cnn --device cpu`` for one epoch, on one
    device and over two spawned gloo ranks: a finite loss and a test
    accuracy; the dp = 2 run's epoch loss equals one device's within the
    trainer bound (the ranks' rows make the same batches). ``main`` runs
    the default MLP."""
    one = mnist_cli_one_device
    assert np.isfinite(one["history"][0]["avg_loss"]) and 0.0 <= one["test_accuracy"] <= 1.0
    if dp == 1:
        assert train_mnist.main(["--device", "cpu", "--epochs", "1", "--batch_size", "100",
                                 "--data_dir", small_mnist]) > 0.1
        return
    out = train_mnist.train(train_mnist.MNISTConfig.parse_args(
        MNIST_CLI + ["--data_dir", small_mnist, "--dp", "2"]), train_mnist.mnist_model,
        train_mnist.mnist_data)
    assert np.isclose(out["history"][0]["avg_loss"], one["history"][0]["avg_loss"],
                      rtol=TRAINER_LOSS_RTOL)
    assert abs(out["test_accuracy"] - one["test_accuracy"]) <= 2 / 2000


def test_train_cifar_resnet_cli_on_cpu():
    """``cli.train_cifar_resnet --device cpu``: the config-4 defaults
    (momentum, ring, plateau) for one short epoch on the synthetic
    fallback; the card is the default device."""
    cfg = train_cifar_resnet.CIFARConfig.parse_args([])
    assert (cfg.device, cfg.batch_size, cfg.lr, cfg.optimizer, cfg.algorithm, cfg.lr_schedule) == (
        "cuda", 256, 0.1, "momentum", "ring", "plateau")
    acc = train_cifar_resnet.main(["--device", "cpu", "--epochs", "1", "--synth_n", "40",
                                   "--batch_size", "12"])
    assert 0.0 <= acc <= 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device was requested"):
            train_cifar_resnet.main(["--epochs", "1", "--synth_n", "40", "--batch_size", "12"])
