"""Seedable open-loop traffic generation for serving benchmarks.

Port of ``deepspeed_tpu/serving/traffic.py``, host logic unchanged.

Open-loop means arrivals follow a fixed stochastic process (Poisson with
rate ``rate_rps``) REGARDLESS of how fast the server responds — the honest
way to measure serving latency (a closed loop self-throttles and hides
queueing collapse; cf. the FastGen benchmark harness's
``--vllm_or_fastgen``-style sweeps over request rate).

Everything is derived from one numpy ``default_rng(seed)``: the same seed
always produces the same arrival times, prompt/output lengths, token ids,
priorities, and deadlines — so scheduler tests and the ``bench.py --rung
sv`` ladder row are reproducible.
"""

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from .request import Request


@dataclass
class LengthDist:
    """A length distribution: ``fixed`` (lo), ``uniform`` [lo, hi], or
    ``lognormal`` (mean≈lo, clipped to [1, hi])."""
    kind: str = "uniform"      # fixed | uniform | lognormal
    lo: int = 16
    hi: int = 64

    def sample(self, rng: np.random.Generator) -> int:
        if self.kind == "fixed":
            return int(self.lo)
        if self.kind == "uniform":
            return int(rng.integers(self.lo, self.hi + 1))
        if self.kind == "lognormal":
            v = rng.lognormal(mean=np.log(max(1, self.lo)), sigma=0.5)
            return int(np.clip(round(v), 1, self.hi))
        raise ValueError(f"unknown length distribution {self.kind!r}")


@dataclass
class TrafficConfig:
    rate_rps: float = 10.0            # mean arrival rate (Poisson)
    num_requests: int = 64
    seed: int = 0
    vocab_size: int = 1024
    prompt_len: LengthDist = field(default_factory=lambda: LengthDist("uniform", 8, 32))
    output_len: LengthDist = field(default_factory=lambda: LengthDist("uniform", 8, 24))
    # optional SLA fields stamped on every request
    deadline_s: Optional[float] = None
    priorities: Tuple[int, ...] = (0,)  # drawn uniformly per request
    # prefix-heavy workload shape (system-prompt reuse, the regime the
    # prefix KV cache targets): when ``system_prompt_pool > 0`` every
    # request's prompt is ``pool[z] + unique suffix`` where the pool holds
    # that many fixed system prompts of ``system_prompt_len`` tokens (drawn
    # once from the same seeded rng) and ``z`` is a Zipf(``zipf_a``) draw —
    # a few system prompts dominate, the tail is cold, matching production
    # template reuse. The unique suffix keeps ``prompt_len`` semantics (it
    # IS the suffix length), so total prompt = system_prompt_len +
    # prompt_len.sample().
    system_prompt_pool: int = 0
    system_prompt_len: int = 0
    zipf_a: float = 1.5


class OpenLoopTraffic:
    def __init__(self, config: TrafficConfig):
        self.config = config

    def schedule(self) -> List[Tuple[float, Request]]:
        """The deterministic arrival schedule: ``[(arrival_offset_s,
        Request), ...]`` sorted by offset (exponential inter-arrival gaps)."""
        c = self.config
        rng = np.random.default_rng(c.seed)
        pool: List[np.ndarray] = []
        if c.system_prompt_pool > 0 and c.system_prompt_len > 0:
            # the pool is drawn BEFORE any per-request randomness so the
            # shared prefixes are identical across runs of the same seed
            # regardless of num_requests
            pool = [rng.integers(0, c.vocab_size, size=c.system_prompt_len)
                    .astype(np.int32) for _ in range(c.system_prompt_pool)]
        out: List[Tuple[float, Request]] = []
        t = 0.0
        for i in range(c.num_requests):
            t += float(rng.exponential(1.0 / c.rate_rps))
            plen = c.prompt_len.sample(rng)
            olen = c.output_len.sample(rng)
            prompt = rng.integers(0, c.vocab_size, size=plen).astype(np.int32)
            if pool:
                z = (int(rng.zipf(c.zipf_a)) - 1) % len(pool)
                prompt = np.concatenate([pool[z], prompt])
            prio = int(rng.choice(c.priorities))
            out.append((t, Request(prompt, max_new_tokens=olen,
                                   priority=prio, deadline_s=c.deadline_s,
                                   request_id=f"req-{c.seed}-{i}")))
        return out

    def run(self, submit: Callable[[Request], object], *,
            clock: Callable[[], float] = time.monotonic,
            sleep: Callable[[float], None] = time.sleep) -> Tuple[list, list]:
        """Replay the schedule in real time against ``submit`` (a server's
        or router's submit). Open-loop: the replay NEVER waits for
        responses, only for arrival times. Returns ``(responses,
        rejected_requests)`` — an overload shed records the request as
        rejected and the loop keeps going; any other submit failure (a
        crashed/closed server) propagates rather than dressing a dead
        server up as drops in a bench row."""
        from .server import ServerOverloaded

        responses, rejected = [], []
        t0 = clock()
        for offset, req in self.schedule():
            delay = t0 + offset - clock()
            if delay > 0:
                sleep(delay)
            try:
                responses.append(submit(req))
            except ServerOverloaded:
                rejected.append(req)
        return responses, rejected
