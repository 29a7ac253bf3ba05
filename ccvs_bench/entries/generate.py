"""Video generation: ``VideoGenerator.generate(rec=False, fake=True)``, the
FVD sampling job: each rollout encodes a batch of clips, continues their
context frames token by token (top-k sampling, KV cache, K2) and decodes the
tokens frame by frame against the FIFO of re-encoded frames.

The window holds whole rollouts back to back, each on a pool batch with a
sampling generator of its own, both drawn from the seed. Once it is over, a
sample of the finished clips drawn from the seed is compared (each a
number beside its limit):

- ``codes_gap``: the context frame's codes, as in ``gpt_train``;
- ``topk_gap``: the worst served token's reference logit below the
  reference's ``top_k``-th largest logit at its position (the top-k
  sampler keeps only tokens at or above it; for ``top_k`` 1 this is the
  greedy gap), over every generated position, the reference running once
  over each clip's served tokens (its logits at prefill and through the
  cache, K2 in every layer);
- ``frame_err``: the worst decoded frame's distance to the reference's
  rollout decode of the same tokens (decoder, warp, correlation, the
  re-encode into the FIFO), relative to the reference frame's norm.
"""

import time

import torch

from ccvs_bench import common, weights
from ccvs_bench.counts import kernels as kcounts
from ccvs_bench.counts import model as mcounts
from ccvs_bench.reference import ae as ref_ae
from ccvs_bench.reference import gpt as ref_gpt
from ccvs_bench.reference.precision import ROUNDING, fp32_mode

FAULTS = ("altered_token", "altered_frame")


class Run:
    def __init__(self, cfg, traffic, seed, device, trace=False, fault=None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault {fault!r}")
        ref_ae.check_supported(cfg["ae"])
        ref_gpt.check_supported(cfg["gpt"])
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.trace, self.fault = torch.device(device), trace, fault
        self.spans = common.Spans(trace and self.device.type == "cuda")
        self.dtrace = None
        self.size = cfg["gpt"]["z_shape"][0] * cfg["gpt"]["z_shape"][1]

    def batch(self, i):
        t, d = self.traffic, self.cfg["ae"]["max_dim"]
        return weights.smooth_clips(weights.generator(self.device, self.seed, 10, i),
                                    (t["batch"], t["frames"], d, d, 3), self.device)

    def setup(self):
        from ccvs_tpu_torch.generate import VideoGenerator
        from ccvs_tpu_torch.models import FrameAutoencoder, TokenTransformer

        cfg, dev, t = self.cfg, self.device, self.traffic
        pcfg = common.port_config(cfg)
        if pcfg.gpt.cond_len != t["context_frames"] * self.size:
            raise ValueError("the traffic's context frames are not the configuration's cond_len")
        ae = FrameAutoencoder(pcfg.ae, dtype=torch.bfloat16, device=dev)
        ae.load_state_dict(weights.make_ae(cfg["ae"], self.seed, dev), strict=True)
        tr = TokenTransformer(pcfg.gpt, dtype=torch.bfloat16, device=dev)
        tr.model.load_state_dict(weights.make_gpt(cfg["gpt"], self.seed, dev), strict=True)
        self.vg = VideoGenerator(pcfg, ae, tr)
        self.spans.wrap(self.vg.transformer, "generate", "tokens")
        self.spans.wrap(self.vg.ae, "decode_video", "decode")
        self._plant_fault()
        self.pool = [self.batch(i) for i in range(t["pool"])]
        # warm-up: the window's encode, then a short rollout at the window's batch
        ae.encode(self.pool[0])
        self.vg.generate(self.pool[-1][:, :t["warmup_frames"]],
                         weights.generator(dev, self.seed, 19), rec=False, fake=True)

    def _plant_fault(self):
        """A fault planted under the timed path, for the check's own tests."""
        if self.fault == "altered_token":
            inner = self.vg.transformer.generate

            def altered(*a, **kw):
                out = inner(*a, **kw)
                out["code"][0, -3] = (out["code"][0, -3] + 1) % self.cfg["gpt"]["z_num"]
                return out

            self.vg.transformer.generate = altered
        elif self.fault == "altered_frame":
            inner = self.vg.ae.decode_video

            def altered(*a, **kw):
                out = inner(*a, **kw)
                out[0, -1] = -out[0, -1]
                return out

            self.vg.ae.decode_video = altered

    def window(self, seconds):
        """Whole rollouts back to back: the next starts while the time so far
        and the last rollout's time fit in ``seconds``. The rate is the
        generated frames of all rollouts over their whole span."""
        from ccvs_bench.tracer import DeviceTrace

        t = self.traffic
        self.spans.events = {}
        self.outs, self.times = [], []
        t0 = common.synced(self.device)
        while not self.times or time.perf_counter() - t0 + self.times[-1] <= seconds:
            j = len(self.times)
            start = time.perf_counter()
            tracing = self.trace and j == 0
            if tracing:
                self.dtrace = DeviceTrace(host=False).__enter__()
            out = self.vg.generate(self.pool[j % len(self.pool)],
                                   weights.generator(self.device, self.seed, 20, j),
                                   rec=False, fake=True)
            if tracing:
                self.dtrace.__exit__(None, None, None)
            self.times.append(common.synced(self.device) - start)
            self.outs.append({"code": out["code"], "fake": out["fake"]})
        span = common.synced(self.device) - t0
        clips = t["batch"] * len(self.times)
        return {"rate": clips * (t["frames"] - t["context_frames"]) / span,
                "attempted": clips, "failed": 0}

    def readings(self):
        t, gpt = self.traffic, self.cfg["gpt"]
        hd = gpt["n_embd"] // gpt["n_head"]
        first = t["context_frames"] * self.size
        positions = range(first, t["frames"] * self.size)
        spans = self.spans.ms()
        return {"spans_ms": spans, "trace": self.dtrace,
                "per_call": {"tokens": len(positions),
                             "decode": t["frames"] - t["context_frames"]},
                "flops": mcounts.rollout(self.cfg, t["batch"], t["frames"], t["context_frames"]),
                "k2_launches": gpt["n_layer"] * len(positions),
                "k2_bytes": gpt["n_layer"] * sum(kcounts.k2_bytes(t["batch"], gpt["n_head"], hd, p)
                                                 for p in positions)}

    def free(self):
        """Drop the program, keeping the sampled clips' outputs for the check:
        the context frame's codes, the served tokens past it and the frames."""
        t = self.traffic
        g = torch.Generator().manual_seed(weights.sub_seed(self.seed, 30))
        n = len(self.outs) * t["batch"]
        pick = torch.randperm(n, generator=g)[:t["check_rows"]].tolist()
        self.rows = [(i // t["batch"], i % t["batch"]) for i in pick]
        first = t["context_frames"] * self.size
        codes = torch.stack([self.outs[r]["code"][b] for r, b in self.rows]).long()
        self.out = {"ctx_codes": codes[:, :first], "tokens": codes[:, first:],
                    "frames": [self.outs[r]["fake"][b].permute(0, 3, 1, 2).float()
                               for r, b in self.rows]}
        for name in ("vg", "pool", "outs"):
            self.__dict__.pop(name, None)
        common.free_cuda()

    def reference(self, rounding="fp32"):
        """The reference over the sampled clips: with ``fp32`` its codes'
        distances, its logits over each clip's served tokens and its decode
        of them; with ``fp8`` (the control) the codes it would choose, the
        tokens it would sample (top-k) at each served position, and its
        decode of the served tokens."""
        q = ROUNDING[rounding]
        cfg, dev, t = self.cfg, self.device, self.traffic
        gpt = cfg["gpt"]
        with fp32_mode():
            ae_p = {k: v.float() for k, v in weights.make_ae(cfg["ae"], self.seed, dev).items()}
            gpt_p = {k: v.float() for k, v in weights.make_gpt(gpt, self.seed, dev).items()}
            ctx = torch.stack([self.batch(r % t["pool"])[b, 0] for r, b in self.rows])
            ctx = ctx.permute(0, 3, 1, 2)
            z = ref_ae.encode(ae_p, cfg["ae"], ctx, q)[0].permute(0, 2, 3, 1).flatten(0, 2)
            d = ref_ae.code_distances(z, ae_p["quantizer.embedding"], q)
            first = t["context_frames"] * self.size
            served = torch.cat([self.out["ctx_codes"], self.out["tokens"]], 1)
            logits = ref_gpt.forward(gpt_p, gpt, served[:, :-1], q)[:, first - 1:]
            ref = {"ctx_codes": d.argmin(1).reshape(len(self.rows), -1)}
            if rounding == "fp32":
                ref.update(dists=(d, (z * z).sum(1)), logits=logits,
                           kth=ref_gpt.kth_logit(logits, gpt["top_k"]))
            else:
                ref["tokens"] = self._sample(logits, gpt)
            ref["frames"] = [ref_ae.decode_video(ae_p, cfg["ae"], served[i:i + 1].reshape(
                1, t["frames"], -1), ctx[i:i + 1], q)[0] for i in range(len(self.rows))]
        return ref

    def _sample(self, logits, gpt):
        """The top-k sampler's draw from ``logits`` ``(R, n, V)``."""
        lg = logits.float() / gpt["temperature"]
        lg = lg.masked_fill(lg < ref_gpt.kth_logit(lg, gpt["top_k"])[..., None], float("-inf"))
        g = weights.generator(self.device, self.seed, 31)
        probs = torch.softmax(lg, -1).flatten(0, 1)
        return torch.multinomial(probs, 1, generator=g).reshape(lg.shape[:2])

    @staticmethod
    def compare(out, ref):
        """The compared numbers of outputs ``out`` (the program's, or a
        control's) against the fp32 reference ``ref``."""
        d, z2 = ref["dists"]
        chosen = d.gather(1, out["ctx_codes"].reshape(-1, 1).to(d.device))[:, 0]
        got = ref["logits"].gather(-1, out["tokens"][..., None].to(d.device))[..., 0]
        frame_err = max(float((torch.linalg.vector_norm(f - r, dim=(1, 2, 3))
                               / torch.linalg.vector_norm(r, dim=(1, 2, 3))).max())
                        for f, r in zip(out["frames"], ref["frames"]))
        return {"codes_gap": float(((chosen - d.min(1).values) / z2).max()),
                "topk_gap": max(0.0, float((ref["kth"] - got).max())),
                "frame_err": frame_err}

    def judge(self, out, detail=False):
        """``out`` (the program's outputs, or a control's) against the fp32
        reference run over the program's served tokens."""
        numbers = self.compare(out, self.reference("fp32"))
        return (numbers, {}) if detail else numbers

    def check(self):
        return self.judge(self.out)
