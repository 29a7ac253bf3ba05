"""Video synthesis: AR token generation + doubly-AR image decode
(counterpart of ``ccvs_tpu/generate.py``): frame continuation; the state-
conditioned, audio-conditioned (STFT), deblurring, class-conditional,
point-to-point and unconditional modes; beam search and the sliding window
for clips longer than the transformer's window (in
:class:`~ccvs_tpu_torch.models.transformer.TokenTransformer`); ``down_size``;
step-by-step generation, which re-encodes each decoded frame; generation
from one image; layout-conditioned generation, whose layout tokens are the
control stream; and :meth:`VideoGenerator.save_batch`, which writes a
batch's clips (and colour-mapped layouts) as MJPEG AVIs.
"""

import os

import numpy as np
import torch

from ccvs_tpu_torch.ops.resize import resize_frames
from ccvs_tpu_torch.parallel.mesh import draw_rows
from ccvs_tpu_torch.utils import profiling, video_io
from ccvs_tpu_torch.train.transformer_trainer import blur_video


class VideoGenerator:
    """Composes the frozen autoencoder, transformer and (for state or audio
    conditioning) state or STFT model into the synthesis pipeline."""

    def __init__(self, cfg, ae, transformer, state_model=None, stft_model=None):
        self.cfg = cfg
        self.ae = ae
        self.transformer = transformer
        self.state_model = state_model
        self.stft_model = stft_model

    @torch.no_grad()
    @profiling.spanned("generate", is_root=True)
    def generate(self, real_vid, generator, rec=True, fake=True, n_ctx_frames=None,
                 keep_state=False, custom_state=None, stft=None, vid_lbl=None, layout=None,
                 down_size=None):
        """Continue the first ``n_ctx_frames`` frames of ``real_vid``.

        Args:
          real_vid: ``(B, T, H, W, 3)`` in [-1, 1], on the models' device.
          generator: the ``torch.Generator`` (on that device) of the token
            sampling, and of the class labels drawn when none are given.
          n_ctx_frames: context frames (default ``cond_len / tokens_per_frame``;
            0 for the unconditional mode).
          keep_state: with state conditioning, give the transformer the whole
            state stream instead of the context frames' states.
          custom_state: ``(B, T, state_size)`` states to condition on instead
            of the estimated ones (implies ``keep_state``), e.g. from
            :meth:`custom_square_state`.
          stft: ``(B, T, 64, 16, 1)`` spectrogram patches, one a frame: with
            ``cfg.gpt.stft`` their audio tokens are the whole given state
            stream.
          vid_lbl: ``(B,)`` class labels (``cfg.gpt.cat``); drawn at random
            when None.
          down_size: degrade ``real_vid`` first: resize its frames to
            ``down_size`` square and back (bilinear, antialiased).
          layout: ``(B, T, H, W)`` integer segmentations: with
            ``cfg.gpt.layout`` (and the autoencoder's shared-decoder layout
            twins) their tokens are the control stream, and the decode is
            :meth:`FrameAutoencoder.decode_video_layout`. Past the context
            the transformer samples the layouts, unless ``keep_state``
            gives it the whole stream (and the decode the given layouts'
            features).

        With ``cfg.gpt.deblurring`` the tokens of the blurred clip are the
        whole given state stream, and the decode's context frames are the
        blurred ones.

        Returns:
          dict with ``fake`` ``(B, T, H, W, 3)`` and ``code`` (its frame
          tokens) unless ``fake=False``; ``rec`` (the rollout decode of the
          real clip's own tokens) with ``rec=True``; ``state_code`` (the state
          or audio stream the transformer ran with, ``(B, T * state_size)``)
          where there is one; with state conditioning ``state`` (the real
          clip's estimated states) and ``fake_state`` ``(B, T, state_size)``
          (the generated states); ``blur`` (the blurred clip) with
          deblurring; ``vid_lbl`` where the labels were drawn here; with
          layouts ``real_layout`` (the given one), ``fake_layout`` and
          ``rec_layout`` (the argmax of the decoded layout logits, ``(B, T,
          H, W)``). In point-to-point mode the last frame of ``fake`` is the
          real end frame.
        """
        cfg = self.cfg
        gcfg = cfg.gpt
        b, t = real_vid.shape[:2]
        size = cfg.ae.tokens_per_frame
        if n_ctx_frames is None:
            n_ctx_frames = gcfg.cond_len // size
        if down_size is not None:
            real_vid = resize_frames(resize_frames(real_vid, down_size), real_vid.shape[2])
        enc = self.ae.encode(real_vid)
        code_all = enc["code"].reshape(b, -1)
        out = {}

        state_code = None
        if gcfg.state and self.state_model is not None and not gcfg.stft:
            out["state"] = self.state_model.estimate(self.ae.embed_code(enc["code"]))
            if custom_state is not None:
                state_code = self.state_model.encode(state=custom_state)
                keep_state = True
            else:
                state_code = self.state_model.encode(state=out["state"])
        if gcfg.stft and self.stft_model is not None and stft is not None:
            state_code = self.stft_model.encode(stft)
        lenc = None
        if gcfg.layout and layout is not None:
            # the layout tokens are the control stream (``generator.py:107-118``)
            if self.ae.encoder_l is None:
                raise ValueError("cfg.gpt.layout needs the autoencoder's layout twins "
                                 "(cfg.ae.use_layout)")
            if gcfg.p2p:
                raise ValueError("layouts with the point-to-point mode are not a reference "
                                 "configuration")
            lenc = self.ae.encode_layout(layout)
            state_code = lenc["code"].reshape(b, -1)
            out["real_layout"] = layout
        ctx_vid = real_vid
        if gcfg.deblurring:
            ctx_vid = out["blur"] = blur_video(real_vid, gcfg.blur_sigma)
            state_code = self.ae.encode(ctx_vid)["code"].reshape(b, -1)
        if gcfg.cat and vid_lbl is None:
            vid_lbl = out["vid_lbl"] = draw_rows(
                self.transformer.data_axis, b, lambda n: torch.randint(
                    0, gcfg.num_lbl, (n,), generator=generator, device=generator.device))

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
        if gcfg.state or gcfg.stft or gcfg.deblurring or gcfg.layout:
            total_len += t_step * gcfg.state_size

        ctx_code = code_all[:, :n_ctx_frames * size]
        # audio and blurred streams are given whole; otherwise the transformer
        # samples the states (or layouts) past the context unless keep_state
        given_stream = gcfg.stft or gcfg.deblurring or keep_state
        if state_code is not None and not given_stream:
            state_code = state_code[:, :n_ctx_frames * gcfg.state_size]

        if fake:
            gen = self.transformer.generate(ctx_code, generator, state_code=state_code,
                                            cond_code=cond_code, delta=delta, lbl=vid_lbl,
                                            total_len=total_len)
            codes = gen["code"][:, :t_step * size]
            out["code"] = codes
            if lenc is not None:
                # the generated (or given) layout tokens drive the shared
                # decoder; past a given stream the rollout re-encodes its own
                # layouts (``quantized_video_model.py:879-897``)
                ss = gcfg.state_size
                lcodes = gen["state_code"][:, :t_step * ss].reshape(b, t_step, ss)
                interl = [f[:, n_ctx_frames:] for f in lenc["inter"]] if given_stream else None
                fake_vid, fake_lay = self.ae.decode_video_layout(
                    codes.reshape(b, t_step, size), lcodes, ctx_vid[:, :n_ctx_frames],
                    layout[:, :n_ctx_frames], n_ctx=n_ctx_frames, interl_gen=interl)
                out["fake_layout"] = fake_lay.float().argmax(-1)
            else:
                fake_vid = self.ae.decode_video(codes.reshape(b, t_step, size),
                                                ctx_frames=ctx_vid[:, :n_ctx_frames],
                                                n_ctx=n_ctx_frames, cond_inter=cond_inter)
            if gcfg.p2p:
                fake_vid = torch.cat([fake_vid, real_vid[:, -1:].to(fake_vid.dtype)], dim=1)
            out["fake"] = fake_vid
            if gen["state_code"] is not None:
                sc = gen["state_code"][:, :t * gcfg.state_size]
                out["state_code"] = sc
                if self.state_model is not None and not gcfg.stft:
                    out["fake_state"] = self.state_model.decode(sc).reshape(b, t,
                                                                            gcfg.state_size)
        if rec and lenc is not None:
            # the rollout of the real tokens with the whole given layout
            # stream (``generator.py:181-184``)
            out["rec"], rec_lay = self.ae.decode_video_layout(
                enc["code"].reshape(b, t, size), lenc["code"].reshape(b, t, size),
                real_vid[:, :n_ctx_frames], layout[:, :n_ctx_frames], n_ctx=n_ctx_frames,
                interl_gen=[f[:, n_ctx_frames:] for f in lenc["inter"]])
            out["rec_layout"] = rec_lay.float().argmax(-1)
        elif rec:
            out["rec"] = self.ae.decode_video(enc["code"].reshape(b, t, size),
                                              ctx_frames=real_vid[:, :n_ctx_frames],
                                              n_ctx=n_ctx_frames)
        return out

    @torch.no_grad()
    @profiling.spanned("generate", is_root=True)
    def generate_step_by_step(self, real_vid, generator, n_ctx_frames=None, fixed_shape=True):
        """Continue ``real_vid`` one frame at a time: the transformer makes a
        frame's tokens, the frame is decoded against the context FIFO, then
        re-encoded, and the re-encode's tokens replace the predicted ones, so
        the transformer always conditions on tokens of the frames it shows.

        ``fixed_shape`` (default) keeps a full-window token buffer and extends
        it with :meth:`TokenTransformer.generate_chunk_fixed`, dropping its
        oldest frame when it is full; ``fixed_shape=False`` grows the token
        stream and calls :meth:`TokenTransformer.generate` on it. The
        point-to-point mode takes the growing path, with the end frame's
        tokens as the prefix (its ``delta`` moved as the window slides) and
        its features as an extra decode context; the real end frame closes
        the clip.

        Returns ``{"fake": (B, T, H, W, 3), "code": (B, T' * tokens a frame)}``:
        the context frames, the generated ones (and the real end frame), and
        the tokens of the context and generated frames, each generated
        frame's those of its re-encode."""
        cfg = self.cfg
        gcfg = cfg.gpt
        ae, tr = self.ae, self.transformer
        b, t = real_vid.shape[:2]
        size = cfg.ae.tokens_per_frame
        m = cfg.ae.skip_memory
        if n_ctx_frames is None:
            n_ctx_frames = gcfg.cond_len // size

        enc = ae.encode(real_vid[:, :n_ctx_frames])
        code = enc["code"].reshape(b, -1)
        # the context FIFO seeded from the real context frames
        fifo = ae._zero_inters(b, m)
        take = min(n_ctx_frames, m)
        for r in range(len(fifo)):
            fifo[r][:, m - take:] = enc["inter"][r][:, n_ctx_frames - take:].to(fifo[r].dtype)

        cond_code = cond_inter = delta = None
        t_gen = t - n_ctx_frames
        keep = gcfg.z_len - gcfg.z_chunk  # tokens kept when the window slides
        if gcfg.p2p:
            fixed_shape = False
            enc_end = ae.encode(real_vid[:, -1:])
            cond_code = enc_end["code"].reshape(b, -1)
            cond_inter = [f[:, -1] for f in enc_end["inter"]]
            delta = torch.full((b,), t - 1, dtype=torch.long, device=code.device)
            t_gen -= 1
            keep -= gcfg.z_chunk  # the cond chunk takes one more
        if fixed_shape and size != gcfg.z_chunk:
            raise ValueError("generate_step_by_step: the fixed-shape path takes the plain frame "
                             "stream (z_chunk == tokens a frame)")
        n = code.shape[1]
        if fixed_shape:
            merged = code.new_zeros(b, gcfg.z_len)
            merged[:, :n] = code

        frames = [real_vid[:, i].to(ae.dtype) for i in range(n_ctx_frames)]
        codes = [code]
        for curr in range(n_ctx_frames, n_ctx_frames + t_gen):
            if n > keep:  # free a chunk of the window
                if fixed_shape:
                    merged = torch.cat([merged[:, n - keep:], merged.new_zeros(b, n - keep)],
                                       dim=1)
                else:
                    if gcfg.p2p:
                        # reposition the delta embedding for the dropped frames
                        delta = delta - ((n - gcfg.z_len) // gcfg.z_chunk + 2)
                    code = code[:, -keep:]
                n = keep
            if fixed_shape:
                merged = tr.generate_chunk_fixed(merged, n, generator)
                chunk = merged[:, n:n + size]
            else:
                total = n + gcfg.z_chunk + (0 if cond_code is None else cond_code.shape[1])
                gen = tr.generate(code, generator, cond_code=cond_code, delta=delta,
                                  total_len=total)
                chunk = gen["code"][:, -size:]
            with profiling.span("decode"):
                frame = ae.decode_frame(ae.embed_code(chunk), fifo, ae.fifo_mask(b, curr),
                                        extra_ctx=cond_inter)
                # re-encode: fresh context features and the frame's own tokens
                new_enc = ae.encode(frame)
                fifo = ae.fifo_push(fifo, new_enc["inter"], curr, cfg.ae.keep_first,
                                    cfg.ae.n_first)
            new_code = new_enc["code"].reshape(b, -1)
            if fixed_shape:
                merged[:, n:n + size] = new_code
            else:
                code = torch.cat([gen["code"][:, :-size], new_code], dim=1)
            n += gcfg.z_chunk
            frames.append(frame)
            codes.append(new_code)
        if gcfg.p2p:
            frames.append(real_vid[:, -1].to(ae.dtype))
        return {"fake": torch.stack(frames, dim=1), "code": torch.cat(codes, dim=1)}

    @torch.no_grad()
    def generate_from_image(self, img, generator, vid_len=None, **kw):
        """A clip of ``vid_len`` frames (default ``cfg.data.vid_len``) from one
        frame ``img`` ``(B, H, W, 3)``: :meth:`generate` with the image as its
        one context frame (and ``rec=False``); ``kw`` go to it."""
        t = vid_len or self.cfg.data.vid_len
        clip = img[:, None].expand(img.shape[0], t, *img.shape[1:]).contiguous()
        return self.generate(clip, generator, n_ctx_frames=1, rec=False, **kw)

    @torch.no_grad()
    def custom_square_state(self, real_vid):
        """A square path of states from each clip's estimated first state
        (the reference's ``--custom_state``), ``(B, T, 2)``."""
        enc = self.ae.encode(real_vid[:, :1])
        init = self.state_model.estimate(self.ae.embed_code(enc["code"]))
        return square_trajectory(init, real_vid.shape[1])

    @staticmethod
    def save_batch(result_path, global_iter, batch_size, real_vid, out, fps=4,
                   imagenet_norm=False, vid_ids=None, cats=None):
        """Write a batch's clips as AVIs under ``result_path``: ``real/``,
        and ``fake/`` and ``rec/`` where ``out`` has them; with states
        (``out["state"]``, ``out["fake_state"]``) also ``real_state/`` and
        ``fake_state/``, copies marked with a cross at each frame's state;
        with layouts (``real_layout``, ``fake_layout``, ``rec_layout``:
        classes ``(B, T, H, W)`` or logits ``(B, T, H, W, n)``) their
        colour-mapped videos (:func:`~ccvs_tpu_torch.utils.video_io.layout_to_uint8`).

        A clip is named ``vid_{id:05d}{_cat}.avi``: ``id`` is ``vid_ids[i]``
        when given (the dataset's ids, ``--include-id``), else ``batch_size *
        global_iter + i``; ``_cat`` is ``_{cats[i]}`` when ``cats`` is given.
        Tensors (any dtype, any device) move once to the host as fp32, so
        the files are byte for byte the JAX package's for the same values."""

        def _vid_name(i):
            vid_id = int(vid_ids[i]) if vid_ids is not None else batch_size * global_iter + i
            suffix = f"_{cats[i]}" if cats is not None else ""
            return f"vid_{vid_id:05d}{suffix}.avi"

        names = {"real": video_io.to_host_f32(real_vid)}
        for name in ("fake", "rec"):
            if name in out:
                names[name] = video_io.to_host_f32(out[name])
        u8s = {}
        for name, vid in names.items():
            u8s[name] = u8 = video_io.to_uint8(vid, imagenet_norm=imagenet_norm)
            for i in range(u8.shape[0]):
                video_io.write_video(os.path.join(result_path, name, _vid_name(i)), u8[i],
                                     fps=fps)
        for name in ("real_layout", "fake_layout", "rec_layout"):
            if name in out:
                seg = out[name]
                if isinstance(seg, torch.Tensor):
                    seg = seg.detach().cpu().numpy()
                if np.ndim(seg) == 5:  # logits -> classes
                    seg = np.argmax(seg, -1)
                u8 = video_io.layout_to_uint8(seg)
                for i in range(u8.shape[0]):
                    video_io.write_video(os.path.join(result_path, name, _vid_name(i)), u8[i],
                                         fps=fps)
        for name, key in (("real_state", "state"), ("fake_state", "fake_state")):
            if key in out:
                u8 = u8s["real" if key == "state" else "fake"]
                st = video_io.to_host_f32(out[key])
                h = u8.shape[2]
                for i in range(u8.shape[0]):
                    marked = u8[i].copy()
                    for j in range(marked.shape[0]):
                        x = min(int(h * st[i, j, 0]), h - 1)
                        y = min(int(h * st[i, j, 1]), h - 1)
                        marked[j] = video_io.draw_cross(marked[j], x, y)
                    video_io.write_video(os.path.join(result_path, name, _vid_name(i)), marked,
                                         fps=fps)


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
