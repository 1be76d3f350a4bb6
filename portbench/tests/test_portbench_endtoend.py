"""The tails as defined: due-based TTFT with censored requests, TPOT over
the tokens received in the window, and the rates."""

from __future__ import annotations

import pytest

from portbench import endtoend
from portbench.endtoend import Record


def test_ttft_counts_due_and_censors_stalls():
    recs = [Record(10, 5, due=0.5, times=[1.5, 2.0]),    # due out of window
            Record(10, 5, due=1.0, times=[1.2, 1.3]),    # 200 ms
            Record(10, 5, due=2.0, times=[]),             # never: 10 - 2
            Record(10, 5, due=3.0, times=[11.0]),         # after the window
            Record(10, 5, due=10.0, times=[10.1])]        # due at t1: out
    assert endtoend.ttfts_ms(recs, 1.0, 10.0) == pytest.approx(
        [200.0, 8000.0, 7000.0])
    assert endtoend.percentile(endtoend.ttfts_ms(recs, 1.0, 10.0),
                               50) == pytest.approx(7000.0)
    assert endtoend.percentile([], 50) is None


def test_tpot_over_window_tokens_only():
    recs = [Record(1, 9, 0.0, times=[0.5, 1.0, 1.0, 1.2, 1.4, 12.0]),
            Record(1, 9, 0.0, times=[2.0, 2.0]),  # one receive time: out
            Record(1, 9, 0.0, times=[3.0])]
    got = endtoend.tpots_ms(recs, 1.0, 10.0)
    # the two tokens received at 1.0 are one arrival: 2 tokens after it
    assert got == pytest.approx([(1.4 - 1.0) / 2 * 1e3])
    one_by_one = [Record(1, 9, 0.0, times=[1.0, 1.1, 1.2, 1.4])]
    assert endtoend.tpots_ms(one_by_one, 1.0, 10.0) == pytest.approx(
        [(1.4 - 1.0) / 3 * 1e3])


def test_rates():
    recs = [Record(100, 9, 0.0, times=[0.5, 1.5, 2.5]),
            Record(40, 9, 1.0, times=[1.2, 3.0, 11.0]),
            Record(7, 9, 2.0, times=[])]
    assert endtoend.output_tok_s(recs, 1.0, 11.0) == pytest.approx(4 / 10)
    assert endtoend.prompt_tok_s(recs, 1.0, 11.0) == pytest.approx(40 / 10)
