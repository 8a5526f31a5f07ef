"""A run with the timed path broken underneath comes out not correct: the
harness's whole run on the CPU at small sizes (its look for a card is in
``run.py`` and is skipped here), once sound and once for each fault a cell
can have (one caller at batch 1, one card: no half batch, no exchange):
a decode step that returns its state unchanged, a served token altered
where it is produced, and a warm pool whose verdict or loads go wrong."""
import pytest
import torch

from portbench.tests import tiny


def sound(workload):
    res = tiny.run(workload)
    assert res["correct"], res["checks"]
    return res


@pytest.mark.parametrize("workload", ["qwen2-7b.code-warm",
                                      "olmoe-1b-7b.code-warm",
                                      "qwen2-7b.code-cold"])
def test_sound_run_is_correct(workload):
    res = sound(workload)
    assert res["attempted"] > 0 and res["failed"] == 0
    from portbench.cell import Cell
    want = {m["name"] for m in Cell(tiny.BENCH, workload).end_to_end}
    want.discard("request_p95_s")          # 200 requests and more only
    assert set(res["metrics"]) == want
    assert res["checks"]["logit_gap_mean"]["value"] <= \
        res["checks"]["logit_gap_mean"]["limit"]


def test_state_left_unchanged_is_caught(monkeypatch):
    from repro_torch.serving import engine

    def step(self):
        logits, _ = self.model.decode_step(self.params, self.token,
                                           self.state)
        self.token.copy_(torch.argmax(logits, dim=-1))
        return logits                     # the new state is not kept

    monkeypatch.setattr(engine.Executable, "_step", step)
    res = tiny.run("qwen2-7b.code-warm")
    assert not res["correct"]
    assert res["checks"]["logit_gap_mean"]["value"] > \
        res["checks"]["logit_gap_mean"]["limit"]


@pytest.mark.parametrize("workload", ["qwen2-7b.code-warm",
                                      "olmoe-1b-7b.code-warm"])
def test_altered_token_is_caught(monkeypatch, workload):
    from repro_torch.serving import engine
    decode = engine.Executable.decode

    def altered(self):
        tok = decode(self)
        return (tok + 1) % self.logits.shape[-1]

    monkeypatch.setattr(engine.Executable, "decode", altered)
    res = tiny.run(workload)
    assert not res["correct"]
    assert res["checks"]["logit_gap_mean"]["value"] > \
        res["checks"]["logit_gap_mean"]["limit"]


def test_altered_prefill_token_is_caught(monkeypatch):
    from repro_torch.serving import engine
    prefill = engine.Executable.prefill

    def altered(self, tokens, embeds=None):
        return (prefill(self, tokens, embeds) + 7) % 512

    monkeypatch.setattr(engine.Executable, "prefill", altered)
    assert not tiny.run("qwen2-7b.code-warm")["correct"]


def test_wrong_pool_verdict_is_caught(monkeypatch):
    from repro_torch.serving import warmpool
    on_request = warmpool.WarmPool.on_request

    def wrong(self, app_id, now):
        cold, lat = on_request(self, app_id, now)
        return (not cold) if self.state[app_id].requests == 3 else cold, lat

    monkeypatch.setattr(warmpool.WarmPool, "on_request", wrong)
    res = tiny.run("qwen2-7b.code-cold")
    assert not res["correct"]
    assert res["checks"]["pool_mismatches"]["value"] > 0


def test_keep_alive_ignored_is_caught(monkeypatch):
    """A pool that never unloads serves every request warm: the cold mix's
    verdicts and unloads differ from the rules'."""
    from repro_torch.serving import warmpool
    monkeypatch.setattr(warmpool.WarmPool, "_unload",
                        lambda self, app_id, now: None)
    res = tiny.run("qwen2-7b.code-cold")
    assert not res["correct"]
    assert res["checks"]["pool_mismatches"]["value"] > 0
