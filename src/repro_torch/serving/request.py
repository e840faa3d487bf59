"""Request lifecycle objects shared by the engine and the benchmarks."""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.scheduler import ReqState, SchedEntry


@dataclass
class Request:
    """One request's full lifecycle state (identity, progress, metrics)."""

    rid: int
    arrival: float
    prompt: list[int]
    max_new_tokens: int = 512
    # oracle ground truth (sim mode / synthetic EOS): output length in tokens
    true_out_len: int = 0
    tenant: str = ""                              # multi-tenant workload tag
    # resilience knobs (0.0 = none; engine-config defaults apply instead)
    deadline_s: float = 0.0                       # completion budget after
                                                  # arrival (engine clock)
    ttft_deadline_s: float = 0.0                  # first-token budget
    retries: int = 0                              # failover re-dispatches
    cancel_reason: str = ""                       # set when CANCELLED
                                                  # ("cancel"|"timeout"|"shed")

    generated: list[int] = field(default_factory=list)
    entry: SchedEntry = None                      # scheduling metadata
    posterior: object = None                      # Bayesian filter state (k,)
    tap_sum: object = None                        # prompt-phase tap accumulator
    tap_cnt: int = 0
    slot: int = -1                                # cache slot (-1 = none)

    # metrics (in engine-clock seconds)
    first_token_time: float = -1.0
    finish_time: float = -1.0

    def __post_init__(self):
        if self.entry is None:
            self.entry = SchedEntry(
                rid=self.rid, arrival=self.arrival,
                prompt_len=len(self.prompt))

    @property
    def context_len(self) -> int:
        """Prompt + generated tokens (what sets the KV footprint)."""
        return len(self.prompt) + len(self.generated)

    @property
    def done(self) -> bool:
        """True once the request reached a terminal state.

        Terminal means FINISHED or CANCELLED — cancelled requests never
        re-enter scheduling.
        """
        return self.entry.state in (ReqState.FINISHED, ReqState.CANCELLED)

    def latency(self) -> float:
        """Completion time: finish minus arrival (engine-clock seconds)."""
        return self.finish_time - self.arrival

    def ttft(self) -> float:
        """Time to first token (engine-clock seconds)."""
        return self.first_token_time - self.arrival
