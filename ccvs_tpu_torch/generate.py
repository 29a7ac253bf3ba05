"""Video synthesis: AR token generation + doubly-AR image decode
(counterpart of ``ccvs_tpu/generate.py``): frame continuation, the state-
conditioned, point-to-point and unconditional modes, and the sliding window
for clips longer than the transformer's window.

Class labels, audio (STFT), deblurring, layouts and ``down_size`` are not
ported yet (``ROADMAP.md``, queue 1).
"""

import numpy as np
import torch


class VideoGenerator:
    """Composes the frozen autoencoder, transformer and (for state
    conditioning) state model into the synthesis pipeline."""

    def __init__(self, cfg, ae, transformer, state_model=None):
        self.cfg = cfg
        self.ae = ae
        self.transformer = transformer
        self.state_model = state_model

    @torch.no_grad()
    def generate(self, real_vid, generator, rec=True, fake=True, n_ctx_frames=None,
                 keep_state=False, custom_state=None, stft=None, vid_lbl=None, layout=None,
                 down_size=None):
        """Continue the first ``n_ctx_frames`` frames of ``real_vid``.

        Args:
          real_vid: ``(B, T, H, W, 3)`` in [-1, 1], on the models' device.
          generator: the ``torch.Generator`` (on that device) of the token
            sampling.
          n_ctx_frames: context frames (default ``cond_len / tokens_per_frame``;
            0 for the unconditional mode).
          keep_state: with state conditioning, give the transformer the whole
            state stream instead of the context frames' states.
          custom_state: ``(B, T, state_size)`` states to condition on instead
            of the estimated ones (implies ``keep_state``), e.g. from
            :meth:`custom_square_state`.
          stft, vid_lbl, layout, down_size: not ported yet; raise.

        Returns:
          dict with ``fake`` ``(B, T, H, W, 3)`` and ``code`` (its frame
          tokens) unless ``fake=False``; ``rec`` (the rollout decode of the
          real clip's own tokens) with ``rec=True``; with state conditioning
          ``state`` (the real clip's estimated states) and ``fake_state``
          ``(B, T, state_size)`` (the generated states) with their tokens
          ``state_code``. In point-to-point mode the last frame of ``fake``
          is the real end frame.
        """
        for name, value in (("stft", stft), ("vid_lbl", vid_lbl), ("layout", layout),
                            ("down_size", down_size)):
            if value is not None:
                raise NotImplementedError(
                    f"generate({name}=...) is not ported yet; see ROADMAP.md, queue 1")
        cfg = self.cfg
        gcfg = cfg.gpt
        b, t = real_vid.shape[:2]
        size = cfg.ae.tokens_per_frame
        if n_ctx_frames is None:
            n_ctx_frames = gcfg.cond_len // size
        enc = self.ae.encode(real_vid)
        code_all = enc["code"].reshape(b, -1)
        out = {}

        state_code = None
        if gcfg.state and self.state_model is not None:
            out["state"] = self.state_model.estimate(self.ae.embed_code(enc["code"]))
            if custom_state is not None:
                state_code = self.state_model.encode(state=custom_state)
                keep_state = True
            else:
                state_code = self.state_model.encode(state=out["state"])

        cond_code = delta = cond_inter = None
        t_step = t  # frames generated and decoded
        if gcfg.p2p:
            # the end frame's tokens are the prefix, its features an extra
            # decode context; the real end frame closes the clip
            t_step = t - 1
            cond_code = code_all[:, -gcfg.z_chunk:]
            delta = torch.full((b,), t - 1, dtype=torch.long, device=code_all.device)
            cond_inter = [f[:, -1] for f in enc["inter"]]
        total_len = t * size  # the prefix's tokens and the body's
        if gcfg.state:
            total_len += t_step * gcfg.state_size

        ctx_code = code_all[:, :n_ctx_frames * size]
        if state_code is not None and not keep_state:
            state_code = state_code[:, :n_ctx_frames * gcfg.state_size]
        ctx_frames = real_vid[:, :n_ctx_frames]

        if fake:
            gen = self.transformer.generate(ctx_code, generator, state_code=state_code,
                                            cond_code=cond_code, delta=delta,
                                            total_len=total_len)
            codes = gen["code"][:, :t_step * size]
            out["code"] = codes
            fake_vid = self.ae.decode_video(codes.reshape(b, t_step, size), ctx_frames=ctx_frames,
                                            n_ctx=n_ctx_frames, cond_inter=cond_inter)
            if gcfg.p2p:
                fake_vid = torch.cat([fake_vid, real_vid[:, -1:].to(fake_vid.dtype)], dim=1)
            out["fake"] = fake_vid
            if gen["state_code"] is not None and self.state_model is not None:
                sc = gen["state_code"][:, :t * gcfg.state_size]
                out["state_code"] = sc
                out["fake_state"] = self.state_model.decode(sc).reshape(b, t, gcfg.state_size)
        if rec:
            out["rec"] = self.ae.decode_video(enc["code"].reshape(b, t, size),
                                              ctx_frames=ctx_frames, n_ctx=n_ctx_frames)
        return out

    @torch.no_grad()
    def custom_square_state(self, real_vid):
        """A square path of states from each clip's estimated first state
        (the reference's ``--custom_state``), ``(B, T, 2)``."""
        enc = self.ae.encode(real_vid[:, :1])
        init = self.state_model.estimate(self.ae.embed_code(enc["code"]))
        return square_trajectory(init, real_vid.shape[1])


def square_trajectory(init_state, vid_len):
    """A square path through [0.2, 0.8)^2 from ``init_state`` ``(B, 1, 2)``:
    steps of 10/64 up, right, down, left, turning where the next step would
    leave the square. Returns ``(B, vid_len, 2)`` fp32 on the input's device."""
    init = init_state.detach().float().cpu().numpy()
    out = np.tile(init, (1, vid_len, 1))
    step = 10 / 64
    deltas = [(0, -step), (step, 0), (0, step), (-step, 0)]

    def inside(u, v):
        return 0.2 <= u < 0.8 and 0.2 <= v < 0.8

    for i in range(init.shape[0]):
        x, y = float(init[i, 0, 0]), float(init[i, 0, 1])
        d = 0
        dx, dy = deltas[d]
        for j in range(1, vid_len):
            while not inside(x + dx, y + dy):
                d = (d + 1) % 4
                dx, dy = deltas[d]
            x += dx
            y += dy
            out[i, j] = (x, y)
    return torch.from_numpy(out).to(init_state.device)
