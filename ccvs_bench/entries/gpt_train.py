"""Transformer training: ``TransformerTrainer.encode_batch`` then
``TransformerTrainer.step``, the frozen autoencoder's encode and one AdamW
update of the GPT (fp32 parameters, bf16 compute), on a pool of seeded
batches cycled through the window.

Set-up builds the one trainer the window drives and takes its first
``check_steps`` steps through the window's own calls, on pool batches that
all differ; the reference follows those steps once the window is over.
Compared (each a number beside its limit):

- ``codes_gap``: the worst latent's excess distance to the code the
  program chose over the nearest code, in the reference's fp32 distances,
  as a share of the latent's squared norm (K1 and the encoder);
- ``loss_gap``: the worst loss, relative, of the steps taken at the initial
  parameters (the first update's learning rate is 0);
- ``grad_gap``: the first step's gradient, read from the program's AdamW
  first moment after that step, by the worst leaf;
- ``change_gap``: the parameters' change over the steps, by the worst leaf.

The two leaf numbers leave out leaves whose reference gradient is under a
thousandth of the median leaf's (a key's bias under softmax): they move by
round-off alone. A later step's loss is not compared: the bf16 forward
reads the fp32 master weights rounded to bf16, which hides most of an
update of ``lr`` 1e-5 on weights of ~0.02 (under bf16's spacing), so the
program's loss after the first update falls by a fifth of the fp32
reference's on every seed. The reference's steps run on the program's own codes: with
seeded weights many latents lie nearly as close to two codes, so bf16 and
fp32 encodes choose differently at many positions; the encode is judged by
``codes_gap`` alone, and the step on the codes it produced.
"""

import statistics
import time

import torch

from ccvs_bench import common, weights
from ccvs_bench.counts import kernels as kcounts
from ccvs_bench.counts import model as mcounts
from ccvs_bench.reference import ae as ref_ae
from ccvs_bench.reference import gpt as ref_gpt
from ccvs_bench.reference.precision import ROUNDING, fp32_mode

FAULTS = ("unchanged_state", "half_batch", "altered_token")


def _torch_optimizer(obj, depth=3):
    """The ``torch.optim.Optimizer`` inside the program's train state."""
    if isinstance(obj, torch.optim.Optimizer):
        return obj
    if depth == 0:
        return None
    for value in vars(obj).values() if hasattr(obj, "__dict__") else ():
        found = _torch_optimizer(value, depth - 1)
        if found is not None:
            return found
    return None


class Run:
    def __init__(self, cfg, traffic, seed, device, trace=False, fault=None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault {fault!r}")
        if traffic["pool"] < traffic["check_steps"]:
            raise ValueError("the checked steps need a pool batch each")
        ref_ae.check_supported(cfg["ae"])
        ref_gpt.check_supported(cfg["gpt"])
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.trace, self.fault = torch.device(device), trace, fault
        self.spans = common.Spans(trace and self.device.type == "cuda")
        self.dtrace = None
        self.traced_steps = 0

    # ---------------------------------------------------------------- inputs

    def _shape(self):
        t = self.traffic
        d = self.cfg["ae"]["max_dim"]
        return (t["batch"], t["frames"], d, d, 3)

    def batch(self, i):
        """Pool batch ``i``: clips drawn from the seed, all rows distinct."""
        return weights.smooth_clips(weights.generator(self.device, self.seed, 10, i),
                                    self._shape(), self.device)

    # ---------------------------------------------------------------- program

    def setup(self):
        from ccvs_tpu_torch.models import FrameAutoencoder
        from ccvs_tpu_torch.train.transformer_trainer import TransformerTrainer

        cfg, dev = self.cfg, self.device
        pcfg = common.port_config(cfg)
        ae_w = weights.make_ae(cfg["ae"], self.seed, dev)
        gpt_w = weights.make_gpt(cfg["gpt"], self.seed, dev)
        self.ae = FrameAutoencoder(pcfg.ae, dtype=torch.bfloat16, device=dev)
        self.ae.load_state_dict(ae_w, strict=True)
        self.tr = TransformerTrainer(pcfg, self.ae, dtype=torch.bfloat16, device=dev)
        gpt = self.tr.transformer.model
        gpt.load_state_dict(gpt_w, strict=True)
        p0 = {k: v.cpu() for k, v in gpt_w.items()}
        del ae_w, gpt_w
        self.state = self.tr.init_state()
        self._plant_fault()
        self.pool = [self.batch(i) for i in range(self.traffic["pool"])]
        names = {id(p): n for n, p in gpt.named_parameters()}
        self.out = {"codes": [], "losses": []}
        for i in range(self.traffic["check_steps"]):
            tokens = self._step(i)
            self.out["codes"].append(tokens["code"].clone())
            self.out["losses"].append(float(self.metrics["nll"]))
            if i == 0:
                self.out["g1"] = self._first_gradient(names)
        self.out["d"] = {n: float(torch.linalg.vector_norm(
            p.detach().float() - p0[n].to(dev).float())) for n, p in gpt.named_parameters()}
        self.step_i = self.traffic["check_steps"]

    def _first_gradient(self, names):
        """Each leaf's gradient norm at the first step, as AdamW got it: its
        first moment after one update over ``1 - beta1``."""
        opt = _torch_optimizer(self.state)
        out = {n: 0.0 for n in names.values()}
        for group in opt.param_groups:
            for p in group["params"]:
                m = opt.state.get(p, {}).get("exp_avg")
                if m is not None:
                    out[names[id(p)]] = float(torch.linalg.vector_norm(m)) / (1 - group["betas"][0])
        return out

    def _plant_fault(self):
        """A fault planted under the timed path, for the check's own tests."""
        if self.fault == "unchanged_state":
            _torch_optimizer(self.state).step = lambda *a, **k: None
        elif self.fault == "half_batch":
            inner = self.tr.step
            self.tr.step = lambda state, tok: inner(
                state, {k: v[:v.shape[0] // 2] for k, v in tok.items()})
        elif self.fault == "altered_token":
            inner = self.tr.encode_batch

            def altered(batch):
                out = inner(batch)
                out["code"][0, 7] = (out["code"][0, 7] + 1) % self.cfg["ae"]["z_num"]
                return out

            self.tr.encode_batch = altered

    def _step(self, i):
        with self.spans.span("encode"):
            tokens = self.tr.encode_batch({"vid": self.pool[i % len(self.pool)]})
        with self.spans.span("step"):
            self.state, self.metrics = self.tr.step(self.state, tokens)
        return tokens

    def window(self, seconds):
        """Steps back to back until ``seconds`` have passed; the rate is the
        input tokens of all steps over the whole window, which ends when the
        device has finished the last step."""
        from ccvs_bench.tracer import DeviceTrace

        traced = self.traffic["traced_steps"] if self.trace else 0
        self.spans.events = {}
        t0 = common.synced(self.device)
        n = 0
        while True:
            if traced and n == 1:
                self.dtrace = DeviceTrace().__enter__()
            self._step(self.step_i)
            self.step_i += 1
            n += 1
            if traced and n == 1 + traced:
                self.dtrace.__exit__(None, None, None)
                self.traced_steps = traced
            if time.perf_counter() - t0 >= seconds:
                break
        dt = common.synced(self.device) - t0
        if traced and self.traced_steps == 0:
            raise RuntimeError(f"the window of {seconds} s ended before the traced steps")
        b, t = self.traffic["batch"], self.traffic["frames"]
        size = self.cfg["gpt"]["z_shape"][0] * self.cfg["gpt"]["z_shape"][1]
        tokens_per_step = b * (min(t * size, self.cfg["gpt"]["z_len"]) - 1)
        return {"rate": n * tokens_per_step / dt, "attempted": n, "failed": 0}

    def readings(self):
        """What the per-layer readers read: spans, the trace, and the work of
        the traced steps."""
        b, t = self.traffic["batch"], self.traffic["frames"]
        ae = self.cfg["ae"]
        n_latents = b * t * ae["z_shape"][0] * ae["z_shape"][1]
        return {"spans_ms": self.spans.ms(), "trace": self.dtrace,
                "flops": mcounts.train_step(self.cfg, b, t) * self.traced_steps,
                "k1": kcounts.k1_work(n_latents, ae["z_num"], ae["z_size"])}

    def free(self):
        for name in ("tr", "ae", "state", "pool", "metrics"):
            self.__dict__.pop(name, None)
        common.free_cuda()

    # ---------------------------------------------------------------- check

    def reference(self, rounding="fp32", codes=None):
        """The reference's outputs of the checked steps: its own encode's
        codes (with the distances that judge a side's codes), then the steps
        on ``codes`` (a side's own, so that each stage is judged by itself;
        by default the reference's): the losses, the first gradient's and
        the change's leaf norms."""
        q = ROUNDING[rounding]
        cfg, dev = self.cfg, self.device
        with fp32_mode():
            ae_p = {k: v.float() for k, v in weights.make_ae(cfg["ae"], self.seed, dev).items()}
            gpt_w = weights.make_gpt(cfg["gpt"], self.seed, dev)
            p = {k: v.float() for k, v in gpt_w.items()}
            cb = ae_p["quantizer.embedding"]
            own, dists = [], []
            for i in range(self.traffic["check_steps"]):
                frames = self.batch(i % self.traffic["pool"]).flatten(0, 1).permute(0, 3, 1, 2)
                zs = [ref_ae.encode(ae_p, cfg["ae"], f, q)[0] for f in frames.split(16)]
                z = torch.cat(zs).permute(0, 2, 3, 1).flatten(0, 2)
                d = ref_ae.code_distances(z, cb, q)
                own.append(d.argmin(1).reshape(self.traffic["batch"], -1))
                dists.append((d, (z * z).sum(1)))
            del ae_p
            losses, g1 = ref_gpt.train_steps(p, cfg["gpt"], own if codes is None else codes, q,
                                             micro=self.traffic["reference_micro"])
            ch = {k: float(torch.linalg.vector_norm(p[k] - gpt_w[k].float())) for k in p}
        return {"codes": own, "dists": dists, "losses": losses, "g1": g1, "d": ch,
                "steps_at_init": ref_gpt.steps_at_init(cfg["gpt"], len(losses))}

    def judge(self, out, detail=False):
        """``out`` (the program's outputs, or a control's) against the fp32
        reference run on ``out``'s codes; with ``detail`` also what
        calibration looks at: each step's loss gap, the worst leaves and the
        median leaf's gaps."""
        ref = self.reference("fp32", codes=out["codes"])
        numbers = self.compare(out, ref)
        if not detail:
            return numbers
        med = statistics.median(ref["g1"].values())
        keep = [k for k, v in ref["g1"].items() if v >= 1e-3 * med]
        info = {"loss_gaps": [abs(a - b) / abs(b) for a, b in zip(out["losses"], ref["losses"])],
                "losses": out["losses"], "ref_losses": ref["losses"],
                "excluded": sorted(set(ref["g1"]) - set(keep))[:8]}
        for key in ("g1", "d"):
            gaps = sorted((abs(out[key][k] - ref[key][k]) / max(ref[key][k], statistics.median(
                ref[key][j] for j in keep)), k) for k in keep)
            info[key + "_worst"] = [(round(g, 6), k, ref[key][k]) for g, k in gaps[-4:]]
            info[key + "_median_gap"] = gaps[len(gaps) // 2][0]
        return numbers, info

    @staticmethod
    def compare(out, ref):
        """The compared numbers of outputs ``out`` (the program's, or a
        control's) against the fp32 reference ``ref``."""
        gap = 0.0
        for code, (d, z2) in zip(out["codes"], ref["dists"]):
            chosen = d.gather(1, code.reshape(-1, 1).long().to(d.device))[:, 0]
            gap = max(gap, float(((chosen - d.min(1).values) / z2).max()))
        med = statistics.median(ref["g1"].values())
        keep = [k for k, v in ref["g1"].items() if v >= 1e-3 * med]
        at_init = zip(out["losses"][:ref["steps_at_init"]], ref["losses"])
        return {"codes_gap": gap,
                "loss_gap": max(abs(a - b) / abs(b) for a, b in at_init),
                "grad_gap": common.worst_leaf_gap(out["g1"], ref["g1"], keep),
                "change_gap": common.worst_leaf_gap(out["d"], ref["d"], keep)}

    def check(self):
        return self.judge(self.out)
