"""The port's device-call retries (battlezips_halo2_tpu_torch/ops/dispatch.py),
the cases of tests/test_dispatch.py on CUDA status codes: a busy card
(cudaErrorDevicesUnavailable) is retried, any other error propagates at once
(a sticky CUDA error too), a card that stays busy raises DeviceUnavailable;
ops/cuda.py::check names the error and carries its code; the batched MSM
and the fused commitments go through device_call, and nested calls retry
once, at the outermost."""

import random

import pytest

from battlezips_halo2_tpu_torch.config import config
from battlezips_halo2_tpu_torch.ops import cuda
from battlezips_halo2_tpu_torch.ops.cuda import CudaError
from battlezips_halo2_tpu_torch.ops.dispatch import DeviceUnavailable, device_call

BUSY = CudaError(46, "cudaErrorDevicesUnavailable", "K2 bz_msm_buckets")
ILLEGAL_ADDRESS = CudaError(700, "cudaErrorIllegalAddress", "K1 bz_quotient_vm")


@pytest.fixture(autouse=True)
def _no_backoff(monkeypatch):
    monkeypatch.setenv("BZ_DISPATCH_BACKOFF_S", "0")


def test_busy_card_is_retried(capsys):
    calls = []

    def flaky(x):
        calls.append(x)
        if len(calls) < 2:
            raise BUSY
        return x + 1

    assert device_call(flaky, 41, what="test op") == 42
    assert len(calls) == 2
    err = capsys.readouterr().err
    assert "test op" in err and "cudaErrorDevicesUnavailable" in err and "attempt 1/3" in err


def test_deterministic_error_propagates():
    calls = []

    def broken(x):
        calls.append(x)
        raise ValueError("shape mismatch")

    with pytest.raises(ValueError, match="shape mismatch"):
        device_call(broken, 0)
    assert len(calls) == 1


@pytest.mark.parametrize("error", [ILLEGAL_ADDRESS, CudaError(719, "cudaErrorLaunchFailure", "K3"),
                                   RuntimeError("CUDA error: all CUDA-capable devices are busy or unavailable")],
                         ids=["illegal address", "launch failure", "text only"])
def test_sticky_or_unclassified_error_is_not_retried(error):
    """Sticky errors end the context; an error without a CUDA code (even one
    whose text reads busy) is not classified by its text."""
    calls = []

    def fails(x):
        calls.append(x)
        raise error

    with pytest.raises(type(error)) as info:
        device_call(fails, 0)
    assert info.value is error and len(calls) == 1


def test_persistent_outage_raises():
    attempts = []

    def down(x):
        attempts.append(x)
        raise BUSY

    with pytest.raises(DeviceUnavailable, match="test op") as info:
        device_call(down, 0, what="test op")
    assert len(attempts) == config().dispatch_retries == 3
    assert info.value.__cause__ is BUSY


def test_nested_calls_retry_at_the_outermost_only():
    inner_calls = []

    def inner():
        inner_calls.append(1)
        raise BUSY

    with pytest.raises(DeviceUnavailable):
        device_call(lambda: device_call(inner, what="inner"), what="outer")
    assert len(inner_calls) == 3  # not 3 x 3
    assert device_call(lambda: 5) == 5  # the depth is reset after a failure


def test_config_defaults_and_environment(monkeypatch):
    monkeypatch.delenv("BZ_DISPATCH_BACKOFF_S")
    cfg = config()
    assert (cfg.dispatch_retries, cfg.dispatch_backoff_s) == (3, 2.0)
    monkeypatch.setenv("BZ_DISPATCH_RETRIES", "5")
    monkeypatch.setenv("BZ_DISPATCH_BACKOFF_S", "0.5")
    assert (config().dispatch_retries, config().dispatch_backoff_s) == (5, 0.5)
    monkeypatch.setenv("BZ_DISPATCH_BACKOFF_S", "0")
    attempts = []

    def down():
        attempts.append(1)
        raise BUSY

    with pytest.raises(DeviceUnavailable):
        device_call(down)
    assert len(attempts) == 5


def test_check_names_the_error_and_carries_the_code(monkeypatch):
    class Library:
        @staticmethod
        def bz_error_name(status):
            return {700: b"cudaErrorIllegalAddress", 46: b"cudaErrorDevicesUnavailable"}[status]

    monkeypatch.setattr(cuda, "_lib", Library())
    cuda.check(0, "K4 bz_ntt_stage")
    with pytest.raises(CudaError, match=r"K4 bz_ntt_stage: CUDA error 700 \(cudaErrorIllegalAddress\)") as info:
        cuda.check(700, "K4 bz_ntt_stage")
    assert (info.value.code, info.value.name) == (700, "cudaErrorIllegalAddress")
    assert isinstance(info.value, RuntimeError)


def test_msm_and_commitments_retry_a_busy_card(monkeypatch):
    """One busy status in the batched MSM's device pass: commit_many,
    commit_lagrange_many and msm_many_table still give the host's points,
    each after one retry of its whole pass."""
    from battlezips_halo2_tpu_torch.curves.host import VESTA
    from battlezips_halo2_tpu_torch.fields.host import FP
    from battlezips_halo2_tpu_torch.ops import msm as M
    from battlezips_halo2_tpu_torch.pcs.ipa import Params, commit_lagrange_many, commit_many
    from battlezips_halo2_tpu_torch.poly.domain import EvaluationDomain

    params = Params.new(3, device="cpu")
    domain = EvaluationDomain(3, 2)
    rng = random.Random(5)
    values = [[rng.randrange(FP.modulus) for _ in range(8)] for _ in range(2)]
    blinds = [rng.randrange(FP.modulus) for _ in range(2)]
    polys = [domain.lagrange_to_coeff(v) for v in values]
    want = [VESTA.pippenger(params.g + [params.w], p + [b]) for p, b in zip(polys, blinds)]

    real = M.msm_wsums
    fails = []

    def busy_once(*args):
        if not fails:
            fails.append(1)
            raise BUSY
        return real(*args)

    monkeypatch.setattr(M, "msm_wsums", busy_once)
    assert commit_many(params, polys, blinds, engine="device") == want
    fails.clear()
    got_polys, got = commit_lagrange_many(params, domain, values, blinds, engine="device")
    assert (got_polys, got) == (polys, want)
    fails.clear()
    scalars = M.ints_to_limbs([v for p, b in zip(polys, blinds) for v in p + [b]], "cpu").reshape(2, 9, 8)
    assert M.msm_many_table(VESTA, params.gw_table(), scalars) == want
    assert len(fails) == 1
