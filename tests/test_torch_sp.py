"""hemx's ``spatial`` mesh axis in hemx_torch (``--spatial_parallel``),
held against hemx's ``(data=2, spatial=2)`` mesh.

The machinery is ``tests/test_torch_tp.py``'s: hemx on ``make_mesh(4,
spatial=2)`` of the 8-device CPU mesh (batch 4 per data shard, global 8)
at XLA backend level 0, against the port in four gloo processes from
hemx's start checkpoint, hemx's global draws handed in through the seam.
Each rank of a model that runs on bands takes its data shard's rows and
its height band of each image (the CNN, the VAE, the GAN, the IWGAN with
its gradient penalty on whole-height rows); ``paper_standalone`` at
65x65, whose height 2 does not divide, runs on whole rows, as hemx falls
back to data-only. Tolerances are hemx's own SP tests'
(``tests/test_models.py::TestSpatialParallel``): the CNN's loss rtol
1e-5, parameters rtol 2e-4 / atol 1e-6 (sgd); the GAN's, the IWGAN's and
paper_standalone's losses rtol 5e-4 / atol 1e-5, the rest rtol 2e-3 /
atol 2e-5; the VAE's ``total_loss`` rtol 1e-5 and its update (the change
of every parameter in the call) rtol 2e-3 / atol 8e-3 of the largest
change, hemx's update-delta form.

After one sgd step at lr 1e-3 a gradient error of the size of the
gradient hides under those tolerances, so the gradients themselves are
held too: on two gloo ranks (data 1 x spatial 2) the CNN's, the VAE's,
the IWGAN critic's (its GP on whole rows), the GAN critic's (BN
statistics over bands), the GAN's and the IWGAN's generator losses
(taken through G's ``Unflatten`` cut to bands, with respect to G's
parameters) and paper_standalone's at 65 px (whole rows on every rank)
equal the same process's gradients of the whole batch, which the
one-device tests hold to hemx's (``tests/test_torch_cnn.py``,
``test_torch_vae.py``, ``test_torch_iwgan.py``, ``test_torch_gan.py``,
``test_torch_paper_standalone.py``).

hemx's own spatial mesh fails that check on two models
(``scripts/hemx_spatial_trace.py``, the 8-device CPU mesh; its model
mesh equals one device's on all four, the VAE's encoder within 2e-4 for
the KL term's conditioning). Its CNN's momentum trace after one
call (its gradient) is 4x one device's on the encoder, the latent dense
and the decoder's d1, c1 and c2, 2x on dc1. Its VAE's decoder shows the
same fault: d1, c1 and c2 at 4.0000x, dc1 at 2.0-2.17x, dc2-dc4 at
1.0000x (the encoder within 6.1e-3, the latent heads within 1.6e-2).
Its GAN and IWGAN are sound under both axes: every kernel, BN beta and
bias not followed by BN within 3.2e-6 of one device's (the biases that
feed a BN have a zero true gradient, and show rounding noise only). So
the ``cnn`` and ``vae`` cases of
``test_four_ranks_match_hemx_data2_spatial2`` rest on a wrong reference
(the VAE's on its decoder) and pass only because sgd's update hides the
gap; the gradient check here and the one-device tests pin them.

The spatial ops alone, in float64 on two gloo ranks: a conv or deconv on
height bands equals the whole-height op (SAME with hemx's asymmetric
padding, VALID, stride 1 and 2, the deconv's crop and ``output_padding``,
and the fall back to whole height where an output height stops dividing)
forward and backward, and the halo exchange, the band gather and the band
cut pass ``gradcheck`` and ``gradgradcheck``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_tp import (  # noqa: E402
    B, HW, LOSS_TOL, TOL, assert_close, assert_metrics, flat, hemx_axes_call,
    image_batches, noise_of, port_ranks, port_result, port_spec)

CNN_LOSS_TOL = dict(rtol=1e-5, atol=0)
CNN_TOL = dict(rtol=2e-4, atol=1e-6)
SGD = dict(optimizer="sgd", lr=1e-3)
CONFIGS = {"cnn": (HW, SGD), "vae": (HW, SGD), "gan": (HW, SGD),
           "iwgan": (HW, dict(n_disc_train=2, **SGD)),
           "paper_standalone": (65, dict(model_version="mean_provided",
                                         g_lr=1e-4, g_beta1=0.5,
                                         g_beta2=0.999))}
# (model, loss) pairs whose spatial gradients are held to one process's
GRADIENT_CASES = [("cnn", "loss"), ("vae", "loss"), ("iwgan", "critic"),
                  ("gan", "critic"), ("gan", "generator"),
                  ("iwgan", "generator"), ("paper_standalone", "loss")]


@pytest.fixture(scope="module")
def calls_done(tmp_path_factory):
    """hemx's call of every configuration, then the port's, all on one
    start of its four ranks: {name: (ref, tmp)}."""
    done, specs = {}, []
    for name in sorted(CONFIGS):
        hw, flags = CONFIGS[name]
        tmp = tmp_path_factory.mktemp(f"sp_{name}")
        ref = hemx_axes_call(name, tmp, image_batches(
            2 * B, hw, depth=name == "paper_standalone"), spatial=2,
            synthetic_shape=[hw, hw, 3], **flags)
        specs.append(port_spec(ref, tmp, noise_of(name, ref, 2 * B),
                               (3, hw, hw)))
        done[name] = (ref, tmp)
    port_ranks(specs)
    return done


@pytest.fixture(params=sorted(CONFIGS))
def case(request, calls_done):
    ref, tmp = calls_done[request.param]
    return (request.param, ref, *port_result(tmp))


def test_four_ranks_match_hemx_data2_spatial2(case):
    name, ref, tree, metrics = case
    state = tree["train_state"]
    assert int(state["step"]) == 1
    if name == "vae":
        np.testing.assert_allclose(metrics["total_loss"],
                                   ref["metrics"]["total_loss"], rtol=1e-5)
        got, want = flat(state["params"]), flat(ref["after"]["params"])
        start = flat(ref["start"]["params"])
        d_got = {k: np.asarray(got[k]) - np.asarray(start[k]) for k in want}
        d_want = {k: np.asarray(want[k]) - np.asarray(start[k]) for k in want}
        scale = max(np.abs(v).max() for v in d_want.values())
        for k in want:
            np.testing.assert_allclose(d_got[k], d_want[k], rtol=2e-3,
                                       atol=8e-3 * scale, err_msg="/".join(k))
        return
    loss_tol, tol = ((CNN_LOSS_TOL, CNN_TOL) if name == "cnn"
                     else (LOSS_TOL, TOL))
    assert_metrics(metrics, ref["metrics"], loss_tol, tol)
    for part in ("params", "mstate", "opt"):
        assert_close(state[part], ref["after"][part], tol)


def _gradients_worker():
    from types import SimpleNamespace

    from hemx_torch.models.plugin import get_model
    from hemx_torch.parallel import dp, mesh
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((4, 3, HW, HW), dtype=np.float32))
    z = torch.from_numpy(rng.standard_normal((4, 16), dtype=np.float32))
    alpha = torch.from_numpy(rng.random((4, 1), dtype=np.float32))
    depth_batch = {
        "image": torch.from_numpy(rng.random((4, 3, 65, 65),
                                             dtype=np.float32)),
        "depth": torch.from_numpy(rng.random((4, 1, 65, 65),
                                             dtype=np.float32))}
    args = SimpleNamespace(latent_size=16, n_disc_train=2, dtype="float32",
                           gp_per_sample=False, vae_parity_loss=False,
                           optimizer="sgd", lr=1e-3,
                           model_version="mean_provided", g_lr=1e-4,
                           g_beta1=0.5, g_beta2=0.999)

    def grads(name, part):
        model = get_model(name)(args, "cpu")
        if name == "paper_standalone":
            # 65 rows: height 2 does not divide, so every rank holds the
            # whole rows and its loss is one term of the mean over ranks
            ts = model.init_state((3, 65, 65), 1)
            prep = model.prepare(depth_batch)
            loss = model._loss(prep["y"], model._forward(ts.nets, prep)[0])
            net = ts.nets
            g = list(torch.autograd.grad(loss, list(net.parameters())))
            dp.all_reduce_grads(g)
            return g
        ts = model.init_state((3, HW, HW), 1)
        h = HW // dp.axis_size()
        band = x[:, :, h * dp.axis_index():h * (dp.axis_index() + 1)]
        if name == "cnn":
            loss = model._forward(ts.nets, band)[1]
            net = ts.nets
        elif name == "vae":
            d, z_mean, z_std, _ = model._forward(ts.nets, band, z)
            loss = model._losses(band, d, z_mean, z_std)["total_loss"]
            net = ts.nets
        elif part == "critic":
            G, net = ts.nets["generator"], ts.nets["discriminator"]
            with torch.no_grad():
                g, _ = model._generate(G, z)
            loss = model._critic_loss(net, 2.0 * (band - 0.5), g,
                                      {"alpha": alpha}, commit=False)
        else:  # the generator's loss through its banded fake
            net, D = ts.nets["generator"], ts.nets["discriminator"]
            g, _ = model._generate(net, z)
            loss = model._g_loss(model._scores(D, g))
        g = list(torch.autograd.grad(loss, list(net.parameters())))
        dp.all_reduce_grads(g)
        return g

    for name, part in GRADIENT_CASES:
        with dp.local():
            want = grads(name, part)
        mesh.make_axes(1, 2)
        got = grads(name, part)
        dp.set_axis(None)
        # float32's rounding at 1e-6 of the largest gradient (it also
        # covers the biases that feed a BN, whose gradient is zero up to
        # rounding); the VAE's KL gradient near z_stddev 0 is
        # ill-conditioned (tests/test_torch_dp_gan.py): at 1e-4 of it
        scale = max(float(b.abs().max()) for b in want)
        atol = (1e-4 if name == "vae" else 1e-6) * scale
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=atol,
                                       msg=f"{name} {part}")


def test_spatial_gradients_equal_one_process():
    from hemx_torch.parallel import mesh
    mesh.spawn(_gradients_worker, 2, device="cpu")


# -- the spatial ops alone -------------------------------------------------

CONV_CASES = [(16, 5, 2, "SAME"), (64, 5, 2, "SAME"), (16, 5, 1, "SAME"),
              (16, 3, 1, "VALID"), (18, 5, 2, "VALID"), (12, 4, 2, "SAME"),
              (4, 5, 2, "SAME"), (2, 5, 2, "SAME")]
DECONV_CASES = [(8, 5, 2, "SAME", 16), (4, 4, 2, "SAME", 8),
                (8, 5, 1, "SAME", 8), (6, 5, 2, "VALID", 16),
                (6, 5, 2, "VALID", 15), (4, 3, 1, "VALID", 6)]


def _band(t, a, s=2):
    n = t.shape[2] // s
    return t[:, :, a * n:(a + 1) * n]


def _ops_worker():
    from hemx_torch.ops import layers
    from hemx_torch.parallel import dp, sp
    dp.set_axis("spatial", 2)
    a = dp.axis_index()
    torch.manual_seed(0)
    cases = [("conv", (h, k, s, p), None) for h, k, s, p in CONV_CASES]
    cases += [("deconv", (h, k, s, p), oh) for h, k, s, p, oh in DECONV_CASES]
    fell_back = 0
    for kind, (h, k, s, pad), oh in cases:
        x = torch.randn(2, 3, h, 7, dtype=torch.float64)
        if kind == "conv":
            w = torch.randn(4, 3, k, k, dtype=torch.float64)
            op = lambda t: layers.conv2d_op(t, w, s, pad)  # noqa: E731
        else:
            w = torch.randn(3, 4, k, k, dtype=torch.float64)
            ow = 7 * s if pad == "SAME" else 6 * s + k
            op = lambda t: layers.deconv2d_op(t, w, (oh, ow), s,  # noqa: E731
                                              pad)
        whole_x = x.clone().requires_grad_(True)
        whole = op(whole_x)
        r = torch.randn_like(whole)
        want_g, = torch.autograd.grad((whole * r).sum(), whole_x)
        band = _band(x, a).clone().requires_grad_(True)
        with sp.bands() as state:
            y = op(band)
        what = f"{kind} {h} k{k} s{s} {pad}"
        if state.banded:
            torch.testing.assert_close(sp.gather(y).detach(), whole.detach(),
                                       rtol=1e-12, atol=1e-12, msg=what)
            loss = (y * _band(r, a)).sum()
        else:  # the whole output on every rank: a share of the loss each
            fell_back += 1
            torch.testing.assert_close(y, whole, rtol=1e-12, atol=1e-12,
                                       msg=what)
            loss = (y * r).sum() / 2
        g, = torch.autograd.grad(loss, band)
        torch.testing.assert_close(g, _band(want_g, a), rtol=1e-12,
                                   atol=1e-12, msg=what)
    assert fell_back == 3  # conv VALID 18 -> 7, SAME 2 -> 1; deconv -> 15


def test_banded_conv_and_deconv_equal_the_whole_op():
    from hemx_torch.parallel import mesh
    mesh.spawn(_ops_worker, 2, device="cpu")


def _pairs_worker():
    from torch.autograd import gradcheck, gradgradcheck

    from hemx_torch.ops import layers
    from hemx_torch.parallel import dp, sp, tp
    dp.set_axis("spatial", 2)
    torch.manual_seed(0)
    w = torch.randn(1, 1, 5, 5, dtype=torch.float64)

    # every rank holds the input and the output whole (tp's copy and
    # reduce: counted once), its band in between
    def halo(x):  # banded conv with the kernel-overlap rows
        with sp.bands():
            y = torch.tanh(layers.conv2d_op(sp.cut(tp.copy(x)), w, 1))
        return tp.reduce(sp.gather(y) / 2)

    def gather(x):  # bands to whole height, a share of it on each rank
        return tp.reduce(torch.sin(sp.gather(sp.cut(tp.copy(x)))) / 2)

    def cut(x):  # each rank's band, placed in zeros
        y = torch.sin(sp.cut(tp.copy(x)))
        return tp.reduce(torch.cat([y if dp.axis_index() == i
                                    else torch.zeros_like(y)
                                    for i in range(2)], 2))

    x = torch.randn(1, 1, 8, 2, dtype=torch.float64, requires_grad=True)
    for fn in (halo, gather, cut):
        assert gradcheck(fn, (x,)), fn.__name__
        assert gradgradcheck(fn, (x,)), fn.__name__


def test_spatial_pairs_gradcheck_and_gradgradcheck():
    """The halo exchange, the band gather (its backward a reduce-scatter:
    every rank's gradient of the band summed) and the band cut, each
    between tp's copy and reduce so that every rank holds the function's
    input and output whole."""
    from hemx_torch.parallel import mesh
    mesh.spawn(_pairs_worker, 2, device="cpu")
