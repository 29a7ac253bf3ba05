"""Video synthesis: AR token generation + doubly-AR image decode
(counterpart of ``ccvs_tpu/generate.py``), for the plain frame-continuation
case: no state, audio, layout, class or end-frame conditioning yet.
"""

import torch


class VideoGenerator:
    """Composes the frozen autoencoder and transformer into the synthesis
    pipeline."""

    def __init__(self, cfg, ae, transformer):
        self.cfg = cfg
        self.ae = ae
        self.transformer = transformer

    @torch.no_grad()
    def generate(self, real_vid, generator, rec=True, fake=True, n_ctx_frames=None):
        """Continue the first ``n_ctx_frames`` frames of ``real_vid``.

        Args:
          real_vid: ``(B, T, H, W, 3)`` in [-1, 1], on the models' device.
          generator: the ``torch.Generator`` (on that device) of the token
            sampling.
          n_ctx_frames: context frames (default ``cond_len / tokens_per_frame``).

        Returns:
          dict with ``fake`` ``(B, T, H, W, 3)`` and ``code`` (its ``(B,
          T*h*w)`` tokens) unless ``fake=False``, and ``rec`` (the rollout
          decode of the real clip's own tokens) with ``rec=True``.
        """
        gcfg = self.cfg.gpt
        b, t = real_vid.shape[:2]
        size = self.cfg.ae.tokens_per_frame
        if n_ctx_frames is None:
            n_ctx_frames = gcfg.cond_len // size
        enc = self.ae.encode(real_vid)
        ctx = real_vid[:, :n_ctx_frames]
        out = {}
        if fake:
            ctx_code = enc["code"].reshape(b, -1)[:, :n_ctx_frames * size]
            code = self.transformer.generate(ctx_code, generator, total_len=t * size)["code"]
            out["code"] = code
            out["fake"] = self.ae.decode_video(code.reshape(b, t, size), ctx_frames=ctx,
                                               n_ctx=n_ctx_frames)
        if rec:
            out["rec"] = self.ae.decode_video(enc["code"].reshape(b, t, size), ctx_frames=ctx,
                                              n_ctx=n_ctx_frames)
        return out
