"""HyRES at N=128, M=192, JPEG quality 1, with the trained weights and
baked tables of ``artifacts/hyres_n128_q1_l0032.msgpack`` (lambda 0.0032).

The program reads the artifact through its own loader; the reference reads
the same raw file through the benchmark's (``reference/msgpack_read.py``).
"""

from __future__ import annotations


def reference_weights(cfg: dict, root, device, ref) -> dict:
    return ref.load_weights(cfg, root, device)


def serving(cfg: dict, root, device, weights, compute_dtype=None):
    from hyres_tpu_torch.models.hyres import HyresCodec

    return HyresCodec.from_artifact(root / cfg["artifact"], compute_dtype=compute_dtype,
                                    device=device, coder=cfg["coder"])


def decompress(codec, compressed: dict):
    """The public decompress call -> (x_hat, decoded symbols)."""
    d = codec.decompress(compressed)
    return d["x_hat"], d["symbols"]


def training(cfg: dict, root, device, weights, traffic: dict, compute_dtype=None):
    """(model, its two optimizers' state, the step) at the traffic's recipe."""
    from hyres_tpu_torch.models.hyres import ResidualJPEGCompression
    from hyres_tpu_torch.train import configure_optimizers, create_train_state, make_train_step
    from hyres_tpu_torch.utils.convert import load_state_dict
    from hyres_tpu_torch.utils.flax_msgpack import load_artifact
    from hyres_tpu_torch.utils.device import resolve_device

    resolve_device(device)
    _, params, _ = load_artifact(root / cfg["artifact"])
    model = ResidualJPEGCompression(cfg["N"], cfg["M"], cfg["jpeg_quality"], compute_dtype)
    load_state_dict(model, params)
    model = model.to(device)
    main, aux = configure_optimizers(model, traffic["lr"], traffic["aux_lr"], traffic["clip"])
    state = create_train_state(model, main, aux)
    return state, make_train_step(state, traffic["lambda"], accum_steps=1)


def reference_name(program_name: str) -> str:
    """The reference's name of a program parameter."""
    return program_name.removeprefix("residual_model.")


def noise_shapes(cfg: dict, batch_shape) -> dict:
    """The draws of one training forward, in the program's layouts: z's
    (N, 1, B*h*w) at 1/32 of the crop, then y's anchor and non-anchor
    (B, h, w, M) at 1/8."""
    B, H, W, _ = batch_shape
    return {"z": (cfg["N"], 1, B * (H // 32) * (W // 32)),
            "y_anchor": (B, H // 8, W // 8, cfg["M"]),
            "y_nonanchor": (B, H // 8, W // 8, cfg["M"])}
