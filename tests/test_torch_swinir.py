"""SwinIR (SwinIR-M x4 real-SR, srgan_st_tpu_torch/models/swinir.py) on
the CPU against the benchmark's plain reference
(benchmark/reference/swinir.py) at a small size with shifting on (embed
20 in 2 heads of 10, a width no multiple of 8 as the published 30 is; 2
RSTBs of 2 blocks, window 4; a 10 x 14 LR frame, so that the reflect pad
and the crop act), its pieces (the window gathers, the shift mask and
its labels, the relative-position index and bias, the attention core,
kernel W's gate), SwinIR's published
state-dict layout, the serving entry's dispatch with its spans and
counters, `infer` on a release-layout checkpoint, and the refusals
(training, export, tiled eval). Imports no JAX; the JAX package has no
SwinIR to hold it to."""

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
from srgan_st_tpu_torch.kernels.swin_attn import label_mask, table_bias
from srgan_st_tpu_torch.models import swinir as S
from srgan_st_tpu_torch.models.swinir import SwinIR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import seeded, seeded_swinir  # noqa: E402
from benchmark.reference import swinir as ref  # noqa: E402

SMALL = dict(in_chans=3, embed_dim=20, depths=[2, 2], num_heads=[2, 2], window_size=4,
             mlp_ratio=2, num_feat=16, qkv_gain=2.0, bias_table_std=2.0, proj_gain=1.0,
             fc2_gain=1.0, conv_last_scale=64.0)  # a frame of std ~0.1 at this size
ARCH = dict(embed_dim=20, num_rstb=2, depth=2, heads=2, window=4, hr_channels=16)


def _weights(cfg=SMALL, seed=2**31 + 7):
    return seeded_swinir.state(cfg, seeded.generator_for(seed, "cpu"), "cpu")


def _model(dtype=torch.float32, sd=None):
    m = SwinIR(**ARCH, dtype=dtype)
    m.load_state_dict(_weights() if sd is None else sd)
    return m.eval()


def _lr(h=10, w=14, seed=3):
    return torch.rand(1, h, w, 3, generator=torch.Generator().manual_seed(seed))


def _config(dtype="float32"):
    from srgan_st_tpu_torch.core.config import Config

    c = Config()
    m = c.MODEL
    m.G_ARCH = "swinir"
    m.G_EMBED_DIM, m.G_N_RSTB, m.G_RSTB_DEPTH, m.G_N_HEADS, m.G_WINDOW, m.G_HR_CHANNEL = (
        20, 2, 2, 2, 4, 16)
    c.TPU.COMPUTE_DTYPE = dtype
    return c


def test_swinir_matches_the_plain_reference_in_float32():
    x = _lr()
    with torch.no_grad():
        got = _model()(x)
    want = ref.upscale(_weights(), x)
    assert got.shape == want.shape == (1, 40, 56, 3) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float(want.std()) > 0.05  # the frame is not flat


def test_swinir_in_bfloat16_within_twice_the_references_own_envelope():
    """bf16 against the f32 reference: within 2x the gap of the reference
    itself computed in bf16 (its parameters and input cast)."""
    x = _lr()
    want = ref.upscale(_weights(), x)
    p16 = {k: v.bfloat16() for k, v in _weights().items()}
    with torch.no_grad():
        own = ref.generator(p16, x.bfloat16()).float()
        got = _model(dtype=torch.bfloat16)(x)
    envelope = float((own - want).abs().max())
    assert 0 < envelope and float((got - want).abs().max()) <= 2 * envelope


@pytest.mark.parametrize("fault", ["no_bias", "no_mask", "unshifted"])
def test_one_blocks_fault_moves_the_frame_past_the_bf16_program(fault, monkeypatch):
    """The seeded gains make one block's bias, mask and shift matter: each
    left out of the first shifted block moves the f32 frame by more than
    5x the bf16 program's own gap."""
    x = _lr()
    want = ref.upscale(_weights(), x)
    with torch.no_grad():
        noise = float((_model(dtype=torch.bfloat16)(x) - want).abs().max())
        m = _model()
        blk = m._blocks[1]
        assert blk.shift == 2
        if fault == "no_bias":
            blk.attn.relative_position_bias_table.data.zero_()
        elif fault == "unshifted":
            blk.shift = 0
        if fault in ("no_mask", "unshifted"):
            plan = S.SwinIR.plan

            def without_mask(self, b, h, w, device):
                orders, labels = plan(self, b, h, w, device)
                return orders, {**labels, 2: None}

            monkeypatch.setattr(S.SwinIR, "plan", without_mask)
        got = m(x)
    assert float((got - want).abs().max()) > 5 * noise


def _swinir_shapes(c=180, layers=6, depth=6, heads=6, ws=8, hidden=360, nf=64):
    """SwinIR(upscale=4, in_chans=3, window_size=8, depths=[6]*6,
    embed_dim=180, num_heads=[6]*6, mlp_ratio=2, upsampler='nearest+conv',
    resi_connection='1conv') of network_swinir.py, written out: its
    parameters (the buffers `relative_position_index` and `attn_mask` are
    recomputed)."""
    out = {"conv_first.weight": (c, 3, 3, 3), "conv_first.bias": (c,),
           "patch_embed.norm.weight": (c,), "patch_embed.norm.bias": (c,)}
    for i in range(layers):
        for j in range(depth):
            b = f"layers.{i}.residual_group.blocks.{j}"
            out.update({f"{b}.norm1.weight": (c,), f"{b}.norm1.bias": (c,),
                        f"{b}.attn.relative_position_bias_table": ((2 * ws - 1) ** 2, heads),
                        f"{b}.attn.qkv.weight": (3 * c, c), f"{b}.attn.qkv.bias": (3 * c,),
                        f"{b}.attn.proj.weight": (c, c), f"{b}.attn.proj.bias": (c,),
                        f"{b}.norm2.weight": (c,), f"{b}.norm2.bias": (c,),
                        f"{b}.mlp.fc1.weight": (hidden, c), f"{b}.mlp.fc1.bias": (hidden,),
                        f"{b}.mlp.fc2.weight": (c, hidden), f"{b}.mlp.fc2.bias": (c,)})
        out[f"layers.{i}.conv.weight"], out[f"layers.{i}.conv.bias"] = (c, c, 3, 3), (c,)
    out.update({"norm.weight": (c,), "norm.bias": (c,),
                "conv_after_body.weight": (c, c, 3, 3), "conv_after_body.bias": (c,),
                "conv_before_upsample.0.weight": (nf, c, 3, 3),
                "conv_before_upsample.0.bias": (nf,)})
    for name in ("conv_up1", "conv_up2", "conv_hr"):
        out[f"{name}.weight"], out[f"{name}.bias"] = (nf, nf, 3, 3), (nf,)
    out["conv_last.weight"], out["conv_last.bias"] = (3, nf, 3, 3), (3,)
    return out


def test_the_published_configuration_has_swinirs_state_dict():
    from benchmark import harness

    m = SwinIR()
    want = _swinir_shapes()
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == want
    assert sum(p.numel() for p in m.parameters()) == sum(
        int(np.prod(s)) for s in want.values()) == 11_715_559
    cfg = harness.load_json("configs", "swinir_m_realsr_x4.json")
    assert dict(seeded_swinir.shapes(cfg)) == want
    assert [b.shift for b in m._blocks] == [0, 4] * 18
    assert m._blocks[0].attn.scale == pytest.approx(30 ** -0.5)


def test_swinir_init_is_swinirs():
    torch.manual_seed(0)
    m = SwinIR(**ARCH).requires_grad_(False)
    blk = m._blocks[1]
    assert float(blk.attn.qkv.weight.std()) == pytest.approx(0.02, rel=0.1)
    assert float(blk.attn.qkv.bias.abs().max()) == 0.0
    assert float(blk.norm1.weight.min()) == float(blk.norm1.weight.max()) == 1.0
    assert float(blk.attn.relative_position_bias_table.std()) == pytest.approx(0.02, rel=0.2)


@pytest.mark.parametrize("window", [4, 8])
def test_relative_position_index_is_swinirs(window):
    assert torch.equal(S.relative_position_index(window), ref.relative_position_index(window))


@pytest.mark.parametrize("shift", [0, 2])
def test_window_gather_is_the_roll_and_the_partition(shift):
    """`window_order` gathers what torch.roll by -shift then
    window_partition give, and its inverse puts a partitioned map back."""
    h, w, c = 8, 12, 5
    x = torch.randn(1, h, w, c, generator=torch.Generator().manual_seed(1))
    perm = S.window_order(h, w, 4, shift)
    rolled = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
    want = ref.window_partition(rolled, 4).reshape(1, h * w, c)
    assert torch.equal(torch.index_select(x.view(1, h * w, c), 1, perm), want)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel())
    assert torch.equal(torch.index_select(want, 1, inv).view(1, h, w, c), x)


@pytest.mark.parametrize("hw", [(8, 12), (16, 8)])
def test_shift_mask_is_calculate_masks(hw):
    got = S.shift_mask(*hw, 4, 2)
    assert torch.equal(got, ref.attention_mask(*hw, 4, 2))
    assert set(got.unique().tolist()) == {-100.0, 0.0}


@pytest.mark.parametrize("hw,window,shift", [((8, 12), 4, 2), ((16, 8), 4, 2),
                                             ((24, 32), 8, 4), ((16, 16), 8, 4)])
def test_the_labels_give_calculate_masks_pattern(hw, window, shift):
    """The region labels of each window's tokens give SwinIR's own mask:
    -100 exactly where two tokens' labels differ, windows in order."""
    labels = S.shift_labels(*hw, window, shift)
    assert labels.dtype == torch.uint8 and labels.shape == (
        hw[0] * hw[1] // window ** 2, window ** 2)
    assert torch.equal(label_mask(labels), ref.attention_mask(*hw, window, shift))


@pytest.mark.parametrize("window", [4, 8])
def test_the_table_and_index_bias_is_the_relative_position_bias(window):
    """The bias read through a block's table and index, as the plain core
    and WindowAttention.bias() read it, against the relative offset of
    every pair of a window's positions written out."""
    heads = 3
    attn = S.WindowAttention(heads * 4, heads, window)
    torch.nn.init.normal_(attn.relative_position_bias_table,
                          generator=torch.Generator().manual_seed(window))
    table = attn.relative_position_bias_table.detach()
    want = torch.empty(heads, window ** 2, window ** 2)
    for i in range(window ** 2):
        for j in range(window ** 2):
            dy, dx = i // window - j // window, i % window - j % window
            want[:, i, j] = table[(dy + window - 1) * (2 * window - 1) + dx + window - 1]
    assert torch.equal(table_bias(table, attn.relative_position_index), want)
    assert torch.equal(attn.bias().detach(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("batch", [1, 2])
def test_window_attention_is_the_plain_softmax_attention(batch, masked, dtype):
    """The core (heads of 10) against softmax(scale q k^T + table[index] +
    mask) v in float64 from the same q, k, v; the mask from the labels of
    the last E windows, or none; one call counted each. float32 within
    1e-5; bf16 within 2^-7 max |v|: p and the output are each rounded once
    to bf16 (relative error at most 2^-8, bf16's unit roundoff; sum p |v|
    and |out| are at most max |v|)."""
    g = torch.Generator().manual_seed(4 + batch)
    nw, ws, heads, hd, e = 6, 4, 2, 10, 3
    n = ws * ws
    qkv = torch.randn(batch * nw, n, 3 * heads * hd, generator=g).to(dtype)
    table = torch.randn((2 * ws - 1) ** 2, heads, generator=g)
    index = S.relative_position_index(ws)
    labels = torch.randint(0, 4, (batch * e, n), generator=g, dtype=torch.uint8) \
        if masked else None
    q, k, v = qkv.view(-1, n, 3, heads, hd).double().permute(2, 0, 3, 1, 4)
    scores = q @ k.transpose(-2, -1) * hd ** -0.5 + table_bias(table, index).double()
    if masked:
        scores[-batch * e:] += label_mask(labels).double().unsqueeze(1)
    want = (torch.softmax(scores, -1) @ v).transpose(1, 2).reshape(batch * nw, n, heads * hd)
    before = S.attn_calls
    got = S.window_attention(qkv, table, index, heads, hd ** -0.5, labels)
    assert S.attn_calls == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * float(v.abs().max())
    assert got.shape == want.shape and got.dtype == dtype
    assert float((got.double() - want).abs().max()) <= tol
    if masked:  # the mask moves the last windows far past that
        free = S.window_attention(qkv, table, index, heads, hd ** -0.5)
        assert float((free[-batch * e:].double() - want[-batch * e:]).abs().max()) > 10 * tol


@pytest.mark.parametrize("batch", [1, 2])
def test_the_plan_puts_the_windows_the_mask_reaches_last(batch):
    """A shifted block's gather holds every window of the rolled map once,
    tokens row-major inside each, those with a masked pair (the last row
    and column of windows) after the others, frame after frame; its labels
    are those windows' regions, frame after frame, and give their masks;
    the unshifted blocks have none; the inverse puts the tokens back."""
    m = _model()
    h, w, ws = 12, 16, 4
    orders, labels = m.plan(batch, h, w, "cpu")
    perm, inv = orders[2]
    mask = S.shift_mask(h, w, ws, 2)
    reached = (mask != 0).flatten(1).any(1)
    rows, cols = h // ws, w // ws
    assert int(reached.sum()) == rows + cols - 1
    frame = S.window_order(h, w, ws, 2).view(-1, ws * ws)
    inner, outer = frame[~reached], frame[reached]
    want = torch.cat([torch.cat([inner + f * h * w for f in range(batch)]).reshape(-1),
                      torch.cat([outer + f * h * w for f in range(batch)]).reshape(-1)])
    assert torch.equal(perm, want)
    assert torch.equal(inv[perm], torch.arange(batch * h * w))
    assert labels[2].dtype == torch.uint8 and labels[2].is_contiguous()
    assert torch.equal(labels[2], S.shift_labels(h, w, ws, 2)[reached].repeat(batch, 1))
    assert torch.equal(label_mask(labels[2]), mask[reached].repeat(batch, 1, 1))
    assert labels[0] is None and torch.equal(orders[0][0], torch.cat(
        [S.window_order(h, w, ws, 0) + f * h * w for f in range(batch)]))


def test_kernel_ws_gate_takes_the_cards_bf16_cores_alone():
    """Kernel W's gate: the published core (heads of 30, windows of 64) in
    bf16 on CUDA without gradients; not the CPU, float32, a gradient, other
    windows, odd or wider heads, or more heads than its shared memory
    holds. The wrapper runs the plain version on the CPU and launches
    nothing."""
    from srgan_st_tpu_torch.kernels import swin_attn as W

    bf = torch.bfloat16
    assert W.gate(False, "cuda", bf, 64, 6, 30) and W.gate(False, "cuda", bf, 64, 8, 32)
    for args in ((False, "cpu", bf, 64, 6, 30), (False, "cuda", torch.float32, 64, 6, 30),
                 (True, "cuda", bf, 64, 6, 30), (False, "cuda", bf, 16, 6, 30),
                 (False, "cuda", bf, 64, 6, 31), (False, "cuda", bf, 64, 6, 34),
                 (False, "cuda", bf, 64, 9, 20), (False, "cuda", bf, 64, 4, 0)):
        assert not W.gate(*args), args
    g = torch.Generator().manual_seed(9)
    qkv = torch.randn(3, 64, 3 * 2 * 8, generator=g).to(bf)
    table, index = torch.randn(225, 2, generator=g), S.relative_position_index(8)
    labels = S.shift_labels(16, 24, 8, 4)[-2:]
    before = W.launches
    got = W.swin_attn(qkv, table, index, 2, 8 ** -0.5, labels)
    assert W.launches == before
    assert torch.equal(got, W.swin_attn_reference(qkv, table, index, 2, 8 ** -0.5, labels))


def test_two_frames_in_one_call_are_each_frame_alone():
    x = torch.cat([_lr(seed=3), _lr(seed=5)])
    m = _model()
    with torch.no_grad():
        both = m(x)
        alone = torch.cat([m(x[:1]), m(x[1:])])
    assert both.shape == (2, 40, 56, 3)
    assert float((both - alone).abs().max()) <= 1e-6
    assert float((both[1:] - ref.upscale(_weights(), x[1:])).abs().max()) <= 1e-5


def _paths(fn) -> list[str]:
    from srgan_st_tpu_torch.tools import profile_step as T

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return T._tree(T.trace_events(prof)[2])[2]


def test_the_serving_entry_dispatches_on_the_architecture():
    """make_generator_apply under G_ARCH "swinir" builds SwinIR from its
    state dict (arrays); a call opens the generator's regions under
    `serve.frame`, each block's `g.attn` (holding `g.attn_core`) and
    `g.mlp` under `g.trunk`, and counts one trunk and one attention core a
    block and no kernel launch (kernel H is the card's)."""
    from srgan_st_tpu_torch import kernels
    from srgan_st_tpu_torch.eval.validate import make_generator_apply

    sd = _weights()
    fn = make_generator_apply(_config(), {k: v.numpy() for k, v in sd.items()}, "cpu")
    assert isinstance(fn.model, SwinIR)
    x = _lr()
    kernels.reset_launch_counts()
    paths = _paths(lambda: fn(x))
    counts = kernels.launch_counts()
    assert counts.pop("swin_trunk") == 1 and counts.pop("window_attn") == 4
    assert set(counts.values()) == {0}
    frame = "serve.frame/g.forward"
    trunk = f"{frame}/g.trunk"
    assert set(paths) == {"serve.frame", frame, trunk, f"{trunk}/g.attn",
                          f"{trunk}/g.attn/g.attn_core", f"{trunk}/g.mlp",
                          *(f"{frame}/g.{part}" for part in ("stem", "upsample", "tail"))}
    assert float((fn(x) - ref.upscale(sd, x)).abs().max()) <= 1e-5
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["swin_trunk"] == kernels.launch_counts()["window_attn"] == 0


def test_the_published_values_are_the_defaults_and_set_accepts_them():
    from srgan_st_tpu_torch.core.config import Config, apply_overrides
    from srgan_st_tpu_torch.models.generator import GENERATOR_ARCHS, build_generator

    cfg = Config()
    m = cfg.MODEL
    assert (m.G_EMBED_DIM, m.G_N_RSTB, m.G_RSTB_DEPTH, m.G_N_HEADS, m.G_WINDOW, m.G_MLP_RATIO,
            m.G_HR_CHANNEL) == (180, 6, 6, 6, 8, 2.0, 64)
    assert "swinir" in GENERATOR_ARCHS
    apply_overrides(cfg, ["MODEL.G_ARCH=swinir", "MODEL.G_EMBED_DIM=20", "MODEL.G_N_RSTB=2",
                          "MODEL.G_RSTB_DEPTH=2", "MODEL.G_N_HEADS=2", "MODEL.G_WINDOW=4",
                          "MODEL.G_MLP_RATIO=2.0", "MODEL.G_HR_CHANNEL=16"])
    g = build_generator(cfg)
    assert isinstance(g, SwinIR) and len(g._blocks) == 4 and g.window == 4
    assert g.conv_up1.weight.shape == (16, 16, 3, 3)


def test_the_hr_weights_add_the_mean_to_conv_last_bias():
    from srgan_st_tpu_torch.kernels.rrdb_hr import RRDBHRWeights

    m = _model()
    convs = [(c.weight, c.bias) for c in m._hr_convs]
    _, bs, laid = RRDBHRWeights(S.MEAN).get(convs)
    assert laid is None  # laid out for the card only
    assert torch.allclose(bs[3], m.conv_last.bias + torch.tensor(S.MEAN))
    assert torch.equal(RRDBHRWeights().get(convs)[1][3], m.conv_last.bias)


def _release(sd, window=4, h=64):
    """sd in SwinIR's release layout: with each block's
    `relative_position_index` and each shifted block's `attn_mask` (for
    img_size h)."""
    out = dict(sd)
    for name in list(sd):
        if name.endswith("attn.relative_position_bias_table"):
            block = name[: -len(".attn.relative_position_bias_table")]
            out[f"{block}.attn.relative_position_index"] = ref.relative_position_index(window)
            if int(block.rsplit(".", 1)[-1]) % 2:
                out[f"{block}.attn_mask"] = ref.attention_mask(h, h, window, window // 2)
    return out


@pytest.mark.parametrize("layout", ["params_ema", "params", "bare"])
def test_infer_loads_a_release_checkpoint_and_derives_the_architecture(tmp_path, layout):
    """A `.pth` as SwinIR releases it ({"params_ema": sd}, with its
    buffers), or {"params": sd}, or a bare state dict: the keys pick
    SwinIR, the shapes its widths and depth; the buffers are dropped."""
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.eval.infer import make_infer_fn, upscale_image

    sd = _weights()
    rel = _release(sd)
    path = str(tmp_path / "003_realSR_BSRGAN_DFO_s64w8_SwinIR-M_x4_GAN.pth")
    torch.save(rel if layout == "bare" else {layout: rel}, path)
    cfg = Config()
    fn = make_infer_fn(cfg, gpath=path, device="cpu")
    assert isinstance(fn.model, SwinIR)
    m = cfg.MODEL
    assert (m.G_ARCH, m.G_EMBED_DIM, m.G_N_RSTB, m.G_RSTB_DEPTH, m.G_N_HEADS, m.G_WINDOW,
            m.G_MLP_RATIO, m.G_HR_CHANNEL, cfg.DATA.UPSCALE_FACTOR) == (
        "swinir", 20, 2, 2, 2, 4, 2.0, 16, 4)
    lr = _lr(10, 14).numpy()[0]
    sr = upscale_image(fn, lr, 4)
    want = ref.upscale(sd, torch.from_numpy(lr)[None])[0].numpy()
    assert sr.shape == (40, 56, 3) and np.abs(sr - want).max() <= 1e-5


def test_only_the_real_sr_layout_is_served():
    sd = _weights()
    with pytest.raises(ValueError, match="nearest\\+conv"):
        S.arch_of_state({k: v for k, v in sd.items() if not k.startswith("conv_up2")})
    with pytest.raises(ValueError, match="1conv"):
        S.arch_of_state({k: v for k, v in sd.items() if not k.startswith("layers.0.conv.")})


@pytest.mark.parametrize("entry", ["warmup", "train"])
def test_training_the_swinir_generator_raises_at_set_up(entry):
    import importlib

    fn = getattr(importlib.import_module(f"srgan_st_tpu_torch.train.{entry}"), entry)
    cfg = _config()
    cfg.DATA.SYNTHETIC = True
    with pytest.raises(ValueError, match="eval only"):
        fn(cfg, device="cpu")


def test_export_refuses_the_swinir_generator():
    from srgan_st_tpu_torch.eval.export import derive_arch, plain_eval_generator

    with pytest.raises(ValueError, match="SRResNet generators only"):
        derive_arch(_weights())
    with pytest.raises(ValueError, match="SRResNet generators only"):
        plain_eval_generator(_config(), {}, device="cpu")


def test_tiled_eval_refuses_swinir():
    """No halo makes a tile exact: the windows align to the frame's origin
    and the shifted windows chain the receptive field over the frame."""
    from srgan_st_tpu_torch.eval.tiled import generator_halo
    from srgan_st_tpu_torch.eval.validate import make_generator_apply

    with pytest.raises(ValueError, match="no exact halo"):
        generator_halo(6, 4, "swinir")
    cfg = _config()
    cfg.TPU.TILED_EVAL = True
    with pytest.raises(ValueError, match="no exact halo"):
        make_generator_apply(cfg, _weights(), "cpu")
