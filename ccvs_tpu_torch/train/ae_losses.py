"""Frame-autoencoder training losses (counterpart of
``ccvs_tpu/train/ae_losses.py``, the reference's ``QVidModel`` losses).

The losses read the modules they are given (the autoencoder, the
discriminators, the frozen VGG) and return graphs: the train steps
(``train/steps.py``) take each loss's gradient with respect to the
parameters they update only.

Batch layout of the image path: groups of ``group_size`` consecutive images
of one video, concatenated along the batch axis, ordered ``[context(,
others...), distorted?]``; with BAIR's ``n_consecutive_img=2`` and an
elastic view each group is ``[A_corrupted_ctx, B, A_distorted]``. The
reference builds its index patterns with Python lists; here they are
integer index tensors derived from the config (:meth:`AELosses.slide_indices`
and the two below).

Each image step and each video step quantizes once: kernel K1 on CUDA. The
codebook takes its gradient through the gather after K1 (``ops/vq.py``).
The image discriminator's losses take ``aug(x, salt=0)``, the adaptive
augmentation of their step (``train/steps.py``), where it is on.
"""

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ccvs_tpu_torch.nn.decoder import SkipDecoder
from ccvs_tpu_torch.nn.vgg import vgg_loss
from ccvs_tpu_torch.ops.resize import resize_bilinear
from ccvs_tpu_torch.ops.warp import backwarp
from ccvs_tpu_torch.parallel.mesh import draw_rows
from ccvs_tpu_torch.train import gan_losses as gl


class AELosses:
    def __init__(self, cfg, ae, di=None, dv=None, df=None, vgg=None):
        self.cfg, self.ae, self.di, self.dv, self.df, self.vgg = cfg, ae, di, dv, df, vgg
        # parallel.mesh.DataAxis of a data-parallel trainer: the context-drop
        # mask is drawn for the global batch and this rank keeps its rows
        self.data_axis = None

    # ---------- index plans ----------

    def group_size(self):
        return self.cfg.n_consecutive_img + (1 if self.cfg.load_elastic_view else 0)

    def slide_indices(self, batch):
        """Per image, the index of the image whose context features are its
        decoder's context (``quantized_video_model.py:285-303``)."""
        cfg = self.cfg
        n, tot = cfg.n_consecutive_img, self.group_size()
        if cfg.slide_inter:
            idx = list(range(1, n)) + [0] + ([0] if cfg.load_elastic_view else [])
        elif cfg.load_elastic_view:
            idx = [0] * tot
        else:
            idx = list(range(tot))
        return np.asarray([g * tot + i for g in range(batch // tot) for i in idx], np.int64)

    def corr_split(self, batch):
        """``(no_corr, corr)``: the images that are not the corrupted
        contexts, and those that are (``quantized_video_model.py:311-326``)."""
        idx = np.arange(batch)
        n = self.cfg.n_consecutive_img
        return idx[idx % (n + 1) != 0], idx[idx % (n + 1) == 0]

    def elastic_indices(self, batch_after_corr):
        """Positions of the distorted views once the corrupted contexts are
        dropped (``quantized_video_model.py:356-357,374-376``)."""
        n = self.cfg.n_consecutive_img
        n = n - 1 if self.cfg.elastic_corruption else n
        return np.asarray([i * (n + 1) + n for i in range(batch_after_corr // (n + 1))],
                          np.int64)

    # ---------- helpers ----------

    def _ckpt(self, fn, *args):
        """``fn(*args)``, recomputed in the backward pass with ``cfg.remat``
        (a trade of about a third more forward work for the activations of
        the encoder, decoder, VGG and discriminators)."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _encode_q(self, img):
        """``(z_q, lambda_quant * VQ loss, context features)``; one K1 launch.
        With ``is_continuous``, ``(z, None, context features)``: the fp32
        latent, no quantizer and no K1."""
        ae = self.ae
        z, inter_enc = self._ckpt(ae.encoder, img.to(ae.dtype))
        if self.cfg.is_continuous:
            return z.float(), None, inter_enc
        z_q, qloss, _ = ae.quantizer(z.float())
        return z_q, qloss * self.cfg.lambda_quant, inter_enc

    def _encode_layout_q(self, layout):
        """``(zl_q, lambda_quant * VQ loss, context features)`` of the layout
        twin; one K1 launch."""
        ae = self.ae
        zl, inter_l = self._ckpt(ae.encoder_l, ae.one_hot_layout(layout).to(ae.dtype))
        zl_q, lql, _ = ae.quantizer_l(zl.float())
        return zl_q, lql * self.cfg.lambda_quant, inter_l

    @staticmethod
    def _layout_ce(logits, layout):
        """Mean cross-entropy of layout logits ``(..., layout_size)`` against
        the integer layout."""
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, layout[..., None].long()).mean()

    def _index(self, idx, x):
        return torch.as_tensor(idx, device=x.device)

    def _adv(self, d, x):
        return gl.GENERATOR_LOSSES[self.cfg.gan_loss](self._ckpt(d, x)) * self.cfg.lambda_gan

    # ---------- generator losses ----------

    def img_generator_loss(self, batch, generator=None, aug=None):
        """``compute_img_to_img_generator_loss``
        (``quantized_video_model.py:251-456``): ``(loss, (metrics, fake))``
        with ``fake = {"img", "z"}``. ``generator`` draws the context-drop
        mask (``inter_drop_p``); ``aug`` augments the fake before the image
        discriminator."""
        cfg, ae = self.cfg, self.ae
        real_img = batch["img"]
        b = real_img.shape[0]
        metrics, loss = {}, 0.0
        z_q, quant_loss, inter_enc = self._encode_q(real_img)
        if quant_loss is not None and not cfg.no_q_img:
            loss = loss + quant_loss
            metrics["quant_img"] = quant_loss

        # the layout twin's encode (``quantized_video_model.py:258-281``)
        real_layout = batch.get("layout")
        zl_q = inter_encl = None
        if cfg.use_layout and real_layout is not None:
            zl_q, lql, inter_encl = self._encode_layout_q(real_layout)
            if not cfg.no_q_img:
                loss = loss + lql
                metrics["layout_quant_img"] = lql

        slide = self._index(self.slide_indices(b), real_img)
        inter_tgt = [f[slide] for f in inter_enc]
        inter_tgtl = None if inter_encl is None else [f[slide] for f in inter_encl]
        real_tgt = real_img
        if cfg.elastic_corruption:
            nc = self._index(self.corr_split(b)[0], real_img)
            z_q, inter_tgt, real_tgt = z_q[nc], [f[nc] for f in inter_tgt], real_img[nc]
            if zl_q is not None:
                zl_q, real_layout = zl_q[nc], real_layout[nc]
                inter_tgtl = [f[nc] for f in inter_tgtl]
        if zl_q is not None and cfg.same_decoder_layout:
            # (``quantized_video_model.py:330-334``)
            inter_tgt = ae.merge_layout_inters(inter_tgt, inter_tgtl)
            z_q = torch.cat([z_q, zl_q], dim=-1)

        keep_mask = None
        if cfg.inter_drop_p > 0:
            u = draw_rows(self.data_axis, z_q.shape[0],
                          lambda n: torch.rand(n, generator=generator, device=z_q.device))
            keep_mask = (u >= cfg.inter_drop_p).float()

        def decode(z, inters, km):
            return ae.decoder(z, inters, return_all=True, keep_mask=km)

        def decode_layout(z, inters, km):
            return ae.decoder_l(z, inters, keep_mask=km)

        fake_img, fake_layout, inter_flows, inter_occs, inter_dec = self._ckpt(
            decode, z_q.to(ae.dtype), SkipDecoder.stack_contexts([inter_tgt]), keep_mask)
        fake_img = fake_img.float()

        # the layout decode and its cross-entropy (``quantized_video_model.py:337-349``)
        if zl_q is not None:
            if not cfg.same_decoder_layout:
                fake_layout = self._ckpt(decode_layout, zl_q.to(ae.dtype),
                                         SkipDecoder.stack_contexts([inter_tgtl]), keep_mask)
            lce = self._layout_ce(fake_layout, real_layout)
            loss = loss + lce
            metrics["layout_img"] = lce
        occ_mask = torch.sigmoid(inter_occs[-1].float()) if inter_occs else None

        if cfg.elastic_corruption and "mask_img" in batch:
            eidx = self._index(self.elastic_indices(fake_img.shape[0]), real_img)
            m = batch["mask_img"].float()  # (groups, H, W, 1), 1 = occluded
            mask_rec = (((occ_mask[eidx] - 1.0) ** 2) * m).sum() / m.sum().clamp_min(1.0)
            loss = loss + mask_rec
            metrics["mask_rec_img"] = mask_rec

        if cfg.use_inter_rec_loss_img:
            irl = sum(((inter_enc[i].float() - inter_dec[-1 - i].float()) ** 2).mean()
                      for i in range(len(inter_enc)))
            loss = loss + irl
            metrics["inter_rec_img"] = irl

        last_flow_mult = SkipDecoder.last_flow_mult(cfg)
        if cfg.use_elastic_flow_recovery and "flow_img" in batch:
            eidx = self._index(self.elastic_indices(fake_img.shape[0]), real_img)
            real_flow = batch["flow_img"].float() / last_flow_mult
            efr = 0.0
            for fake_flow in inter_flows:
                ef = fake_flow.float()[eidx]
                h, w = ef.shape[1:3]
                rf = resize_bilinear(real_flow, h, w)
                if cfg.elastic_corruption and "mask_img" in batch:
                    m = resize_bilinear(batch["mask_img"].float(), h, w)
                    no_occ = (m < 0.5).float()
                    efr = efr + ((((ef - rf) ** 2) * no_occ).sum()
                                 / (no_occ.sum() * 2).clamp_min(1.0))
                else:
                    efr = efr + ((ef - rf) ** 2).mean()
            loss = loss + efr
            metrics["elastic_flow_rec_img"] = efr

        if cfg.use_backwarp_consistency_img and inter_flows:
            flow = inter_flows[-1].float() * last_flow_mult
            r = real_img[slide]
            if cfg.elastic_corruption:
                r = r[nc]
            warped = backwarp(r.float(), flow)
            occ_sum = (1.0 - occ_mask).sum(dim=(1, 2, 3), keepdim=True)
            bwc = ((fake_img - warped) ** 2 * (1.0 - occ_mask) / occ_sum).mean()
            loss = loss + bwc
            metrics["backwarp_consistency_img"] = bwc

        rec = (real_tgt.float() - fake_img).abs().mean()
        metrics["rec_img"] = rec
        if cfg.use_direct_recovery_img:
            loss = loss + rec

        if cfg.use_vgg_img and self.vgg is not None:
            v = self._ckpt(vgg_loss, self.vgg, fake_img, real_tgt) * cfg.lambda_vgg
            loss = loss + v
            metrics["vgg_img"] = v

        if cfg.use_di and self.di is not None:
            adv = self._adv(self.di, fake_img if aug is None else aug(fake_img))
            loss = loss + adv
            metrics["gen_img"] = adv

        # the feature discriminator: images are its "fake" domain
        if cfg.use_df and self.df is not None:
            advf = gl.g_logistic(self.df(z_q.float()))
            loss = loss + advf
            metrics["gen_feat_fake"] = advf
        return loss, (metrics, {"img": fake_img, "z": z_q})

    def vid_generator_loss(self, batch, generator=None):
        """``compute_vid_to_vid_generator_loss``
        (``quantized_video_model.py:483-627``): the image-space rollout over
        ``vid_len`` frames, each decoded against the re-encoded frames before
        it (up to ``skip_memory``, at the ``skip_context`` offsets); only the
        newest context keeps its gradient. ``(loss, (metrics, fake))`` with
        ``fake = {"vid", "z", "unc_vid"}``."""
        cfg, ae = self.cfg, self.ae
        real_vid = batch["vid"]
        metrics = {}
        z_q, quant_loss, inter_enc = self._encode_q(real_vid)
        loss = 0.0
        if quant_loss is not None:
            loss = quant_loss
            metrics["quant_vid"] = quant_loss

        # the layout twins: merged context features and concatenated latents
        # (``quantized_video_model.py:490-520``)
        real_layout = batch.get("layout")
        use_layout = cfg.use_layout and cfg.same_decoder_layout and real_layout is not None
        if use_layout:
            zl_q, lql, inter_encl = self._encode_layout_q(real_layout)
            if not cfg.no_q_img:
                loss = loss + lql
                metrics["layout_quant_vid"] = lql
            inter_enc = ae.merge_layout_inters(inter_enc, inter_encl)
            z_q = torch.cat([z_q, zl_q], dim=-1)

        delta = 1 if cfg.p2p_context else 0
        inters = []
        if cfg.p2p_context:
            inters.append([f[:, -1] for f in inter_enc])
        inters.append([f[:, 0] for f in inter_enc])
        fakes = [real_vid[:, 0].float()]
        fake_layouts = []
        curr = 1
        for i in range(1, cfg.vid_len - delta):
            inter_tgts = [inters[-dt] for dt in cfg.skip_context if dt <= curr]
            fake_img = self._ckpt(ae.decoder, z_q[:, i].to(ae.dtype),
                                  SkipDecoder.stack_contexts(inter_tgts))
            if use_layout:
                fake_img, fake_layout = fake_img
            _, new_inter = self._ckpt(ae.encoder, fake_img)
            if use_layout:
                # the layout logits re-encoded as they are, as the JAX
                # package does (``quantized_video_model.py:538-543``)
                fake_layouts.append(fake_layout.float())
                _, new_interl = self._ckpt(ae.encoder_l, fake_layout)
                new_inter = ae.merge_layout_inters(new_inter, new_interl)
            if len(inters) >= cfg.skip_memory:
                inters.pop(delta)
            else:
                curr += 1
            if inters:
                inters[-1] = [f.detach() for f in inters[-1]]
            inters.append(new_inter)
            fakes.append(fake_img.float())
        if cfg.p2p_context:
            fakes.append(real_vid[:, -1].float())
        fake_vid = torch.stack(fakes, dim=1)

        frame = real_vid.shape[2:]
        real_flat = real_vid[:, 1:].reshape(-1, *frame).float()
        fake_flat = fake_vid[:, 1:].reshape(-1, *frame)
        if fake_layouts:
            fl = torch.stack(fake_layouts, dim=1)
            lce = self._layout_ce(fl, real_layout[:, 1:fl.shape[1] + 1])
            loss = loss + lce
            metrics["layout_vid"] = lce

        rec = (real_flat - fake_flat).abs().mean()
        metrics["rec_vid"] = rec
        if cfg.use_direct_recovery_vid:
            loss = loss + rec

        if cfg.use_vgg_vid and self.vgg is not None:
            v = self._ckpt(vgg_loss, self.vgg, fake_flat, real_flat) * cfg.lambda_vgg
            loss = loss + v
            metrics["vgg_vid"] = v

        if cfg.use_dv and self.dv is not None:
            adv = self._adv(self.dv, fake_vid)
            loss = loss + adv
            metrics["gen_vid"] = adv

        # the unconditional head: every frame decoded without context
        # (``quantized_video_model.py:587-601``)
        fake_unc_vid = None
        if cfg.use_unc_gen:
            fake_unc_vid = ae.decoder(z_q.to(ae.dtype), None, has_ctx=False)
            if use_layout:
                fake_unc_vid = fake_unc_vid[0]
            fake_unc_vid = fake_unc_vid.float()
            unc_img = fake_unc_vid.reshape(-1, *frame)
            real_all = real_vid.reshape(-1, *frame).float()
            if cfg.use_di and self.di is not None:
                adv = gl.GENERATOR_LOSSES[cfg.gan_loss](self.di(unc_img)) * cfg.lambda_gan
                loss = loss + adv
                metrics["gen_img_unc"] = adv
            per = (real_all - unc_img).abs().mean()
            if self.vgg is not None:
                per = per + vgg_loss(self.vgg, unc_img, real_all) * cfg.lambda_vgg
            loss = loss + per
            metrics["per_img_unc"] = per

        # the feature discriminator: videos are its "real" domain
        if cfg.use_df and self.df is not None:
            advf = gl.g_logistic_real(self.df(z_q.float()))
            loss = loss + advf
            metrics["gen_feat_real"] = advf
        return loss, (metrics, {"vid": fake_vid, "z": z_q, "unc_vid": fake_unc_vid})

    # ---------- discriminator losses ----------

    def _no_corr(self, real_img):
        if self.cfg.elastic_corruption:
            return real_img[self._index(self.corr_split(real_img.shape[0])[0], real_img)]
        return real_img

    def img_discriminator_loss(self, real_img, fake_img, fake_z=None, aug=None):
        """``compute_img_discriminator_loss`` (``quantized_video_model.py:629-666``):
        ``(loss, (metrics, real_score))``; the fakes take no gradient.
        ``aug`` augments the real (salt 0) and the fake (salt 1) images
        independently."""
        cfg = self.cfg
        real_img = self._no_corr(real_img)
        metrics, loss, real_score = {}, 0.0, None
        if cfg.use_di:
            fake_img = fake_img.detach()
            if aug is not None:
                real_img, fake_img = aug(real_img, 0), aug(fake_img, 1)
            fake_score = self._ckpt(self.di, fake_img)
            real_score = self._ckpt(self.di, real_img)
            d = gl.DISCRIMINATOR_LOSSES[cfg.gan_loss](real_score, fake_score) * cfg.lambda_gan
            loss = loss + d
            metrics["dis_img"] = d
        if cfg.use_df and fake_z is not None:
            d = gl.d_logistic_fake_only(self.df(fake_z.detach()))
            loss = loss + d
            metrics["dis_feat_fake"] = d
        return loss, (metrics, real_score)

    def vid_discriminator_loss(self, real_vid, fake_vid, fake_z=None, fake_unc_vid=None):
        """``compute_vid_discriminator_loss`` (``quantized_video_model.py:704-741``):
        ``(loss, metrics)``."""
        cfg = self.cfg
        metrics, loss = {}, 0.0
        if cfg.use_dv:
            fs = self._ckpt(self.dv, fake_vid.detach())
            rs = self._ckpt(self.dv, real_vid)
            d = gl.DISCRIMINATOR_LOSSES[cfg.gan_loss](rs, fs)
            loss = loss + d
            metrics["dis_vid"] = d
        if cfg.use_unc_gen and fake_unc_vid is not None and cfg.use_di:
            frame = real_vid.shape[2:]
            fs = self.di(fake_unc_vid.reshape(-1, *frame).detach())
            rs = self.di(real_vid.reshape(-1, *frame))
            d = gl.DISCRIMINATOR_LOSSES[cfg.gan_loss](rs, fs) * cfg.lambda_gan
            loss = loss + d
            metrics["dis_img_unc"] = d
        if cfg.use_df and fake_z is not None:
            d = gl.d_logistic_real_only(self.df(fake_z.detach()))
            loss = loss + d
            metrics["dis_feat_real"] = d
        return loss, metrics

    def img_r1_loss(self, real_img, aug=None):
        """``lambda_r1 / 2 * R1 * d_reg_every`` on the real images that are
        not corrupted contexts (``quantized_video_model.py:669-701``); with
        ``aug`` the penalty is on the gradient of D of the augmented image,
        taken with respect to the image before the augmentation."""
        cfg = self.cfg
        d = self.di if aug is None else (lambda x: self.di(aug(x)))
        gp = gl.r1_penalty(d, self._no_corr(real_img))
        return cfg.lambda_r1 / 2.0 * gp * (cfg.d_reg_every or 1)

    def vid_r1_loss(self, real_vid):
        """The video discriminator's R1 (``quantized_video_model.py:744-770``)."""
        cfg = self.cfg
        gp = gl.r1_penalty(self.dv, real_vid)
        return cfg.lambda_r1 / 2.0 * gp * (cfg.d_reg_every or 1)
