"""The RRDB generator's work a frame, counted from the shapes whatever
implements it (2 FLOPs a multiply-accumulate; bytes in bf16, each input
once and each output once), by part: the dense trunk (the RRDBs and
conv_body, at the LR size) and the HR stage (conv_up1 at 2x; conv_up2,
conv_hr, conv_last at 4x). At 540 x 960: 18.59 TFLOP a frame, 17.18 of
them the trunk's."""

from __future__ import annotations

from benchmark.work import BF16, bound_seconds, conv_macs


def rdb_macs_per_px(cfg: dict) -> int:
    """One dense block at one LR pixel: c1..c4 read nf + k gc channels and
    write gc, c5 reads nf + 4 gc and writes nf (239,616 at 64 / 32)."""
    nf, gc = cfg["num_feat"], cfg["num_grow_ch"]
    return 9 * (sum((nf + k * gc) * gc for k in range(4)) + (nf + 4 * gc) * nf)


def trunk_flops(h: int, w: int, cfg: dict) -> float:
    """The `g.trunk` region: 3 dense blocks an RRDB and conv_body."""
    nf = cfg["num_feat"]
    return 2.0 * (h * w * 3 * cfg["num_block"] * rdb_macs_per_px(cfg)
                  + conv_macs(h, w, nf, nf, 3))


def trunk_bytes(h: int, w: int, cfg: dict) -> float:
    """The trunk's input and output (nf channels at the LR size) and its
    kernels."""
    nf, gc, nb = cfg["num_feat"], cfg["num_grow_ch"], cfg["num_block"]
    kernels = 3 * nb * rdb_macs_per_px(cfg) + 9 * nf * nf
    return BF16 * (2 * h * w * nf + kernels)


def hr_stage(h: int, w: int, cfg: dict) -> tuple[float, float]:
    """(FLOPs, bytes) of the `g.upsample` and `g.tail` regions on an LR
    frame of h x w: conv_up1 at 2x, conv_up2 and conv_hr at 4x (nf -> nf),
    conv_last at 4x (nf -> out); each conv reads its input before the
    nearest x2 (the upsample folded into the read) and writes its output
    once, in bf16; the clamped output in float32."""
    nf, cout = cfg["num_feat"], cfg["num_out_ch"]
    macs = (conv_macs(2 * h, 2 * w, nf, nf, 3) + 2 * conv_macs(4 * h, 4 * w, nf, nf, 3)
            + conv_macs(4 * h, 4 * w, nf, cout, 3))
    hw = h * w
    acts = nf * hw * ((1 + 4) + (4 + 16) + (16 + 16) + 16)
    nbytes = BF16 * (acts + 9 * nf * (3 * nf + cout)) + 4 * 16 * hw * cout
    return 2.0 * macs, nbytes


def frame_flops(h: int, w: int, cfg: dict) -> float:
    """The whole forward of one LR frame: conv_first, the trunk, the HR
    stage."""
    stem = 2.0 * conv_macs(h, w, cfg["num_in_ch"], cfg["num_feat"], 3)
    return stem + trunk_flops(h, w, cfg) + hr_stage(h, w, cfg)[0]


def trunk_bound_seconds(h: int, w: int, cfg: dict) -> float:
    return bound_seconds(trunk_flops(h, w, cfg), trunk_bytes(h, w, cfg))
