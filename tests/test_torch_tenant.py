"""The port's in-pod tenant contract (``tpushare_torch/utils/tenant.py``):
the JAX package's ``tests/test_tenant.py`` cases against the port's
guard, plus what the card changes. Here there is no card: the guard's
reads are injected (``used_bytes_fn``), and the NVML mirroring rule runs
over ``tests/test_torch_plugin.py``'s fake NVML.

- The env: the poison in either spelling, the card list from
  ``NVIDIA_VISIBLE_DEVICES`` (``ALIYUN_COM_TPU_MEM_IDX`` where it names
  no index), the JAX function's answer for any env without it.
- The guard: a breach in the main thread, the cooldown, ``raise | log |
  off`` and an unknown mode failing closed, a re-init stopping the old
  guard, ``HbmGuard(enforce=True)`` installing its own handler.
- The card's half on the CPU: importing the module and calling
  ``apply_tenant_limits`` initializes no CUDA; the fraction is queued for
  CUDA's first use, per card, from the limit and the card's total.
"""

import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from tpushare.utils import tenant as jtenant
from tpushare_torch.utils import tenant

from tests.test_torch_plugin import FakeNvml, _cards

ENV_KEYS = ("NVIDIA_VISIBLE_DEVICES", "CUDA_VISIBLE_DEVICES",
            "TPU_VISIBLE_CHIPS", "TPU_VISIBLE_DEVICES",
            "ALIYUN_COM_TPU_MEM_IDX", "TPUSHARE_HBM_LIMIT_BYTES",
            "ALIYUN_COM_TPU_MEM_POD", "ALIYUN_COM_TPU_MEM_CONTAINER",
            "ALIYUN_COM_TPU_MEM_DEV", "CTPU_DISABLE", "TPUSHARE_HBM_ENFORCE",
            "TPUSHARE_KV_BLOCK_RESERVE", "TPUSHARE_KV_BLOCK_LIMIT")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def clean_env():
    """No grant in the env; the whole env restored after, including what
    the mirroring wrote; nothing queued for a CUDA init. It takes no
    other fixture, so its restore runs after monkeypatch's."""
    saved = dict(os.environ)
    lazy = torch.cuda._lazy_call
    for k in ENV_KEYS:
        os.environ.pop(k, None)
    torch.cuda._lazy_call = lambda fn, **kw: None
    yield
    torch.cuda._lazy_call = lazy
    os.environ.clear()
    os.environ.update(saved)


@pytest.fixture
def restore_enforce_signal():
    old = signal.getsignal(tenant._ENFORCE_SIGNAL)
    yield
    if tenant._enforcing_guard is not None:
        tenant._enforcing_guard.stop()
        tenant._enforcing_guard = None
    signal.signal(tenant._ENFORCE_SIGNAL, old)


def set_env(monkeypatch, **kv):
    for k, v in kv.items():
        monkeypatch.setenv(k, v)


GRANT = {"NVIDIA_VISIBLE_DEVICES": "0",
         "ALIYUN_COM_TPU_MEM_CONTAINER": "8",
         "ALIYUN_COM_TPU_MEM_DEV": "79",
         "TPUSHARE_HBM_LIMIT_BYTES": str(8 << 30)}


# -- the env -------------------------------------------------------------------

def test_read_tenant_env_takes_the_card_selector(monkeypatch):
    set_env(monkeypatch, **dict(GRANT, NVIDIA_VISIBLE_DEVICES="1,2",
                                TPU_VISIBLE_CHIPS="3"))
    spec = tenant.read_tenant_env()
    assert spec.chips == [1, 2]
    assert spec.hbm_limit_bytes == 8 << 30
    assert spec.hbm_fraction == 8 / 79


def test_card_list_falls_back_to_the_index_annotation(monkeypatch):
    set_env(monkeypatch, NVIDIA_VISIBLE_DEVICES="all",
            ALIYUN_COM_TPU_MEM_IDX="3")
    assert tenant.read_tenant_env().chips == [3]
    set_env(monkeypatch, NVIDIA_VISIBLE_DEVICES="2")
    assert tenant.read_tenant_env().chips == [2]


@pytest.mark.parametrize("key,value,named", [
    ("NVIDIA_VISIBLE_DEVICES", "no-gpu-has-8GiB-to-run",
     "NVIDIA_VISIBLE_DEVICES"),
    ("NVIDIA_VISIBLE_DEVICES", "no-tpu-has-8GiB-to-run",
     "NVIDIA_VISIBLE_DEVICES"),
    # The TPU spellings name TPU_VISIBLE_CHIPS, as the JAX function does.
    ("TPU_VISIBLE_CHIPS", "no-tpu-has-8GiB-to-run", "TPU_VISIBLE_CHIPS"),
    ("TPU_VISIBLE_DEVICES", "no-gpu-has-4GiB-to-run", "TPU_VISIBLE_CHIPS"),
])
def test_poisoned_env_raises(monkeypatch, key, value, named):
    set_env(monkeypatch, **{key: value})
    with pytest.raises(tenant.AllocationError, match=named):
        tenant.read_tenant_env()
    with pytest.raises(tenant.AllocationError):
        tenant.apply_tenant_limits()


@pytest.mark.parametrize("env", [
    {"TPU_VISIBLE_CHIPS": "1,2", "ALIYUN_COM_TPU_MEM_IDX": "5",
     "TPUSHARE_HBM_LIMIT_BYTES": "77"},
    {"TPU_VISIBLE_DEVICES": "0", "ALIYUN_COM_TPU_MEM_CONTAINER": "4",
     "ALIYUN_COM_TPU_MEM_DEV": "16", "CTPU_DISABLE": "true"},
    {"ALIYUN_COM_TPU_MEM_IDX": "3"},
])
def test_without_the_card_selector_equals_the_jax_function(monkeypatch, env):
    set_env(monkeypatch, **env)
    assert tenant.read_tenant_env().__dict__ == \
        jtenant.read_tenant_env().__dict__


def test_kv_quota_env(monkeypatch):
    set_env(monkeypatch, NVIDIA_VISIBLE_DEVICES="0",
            TPUSHARE_KV_BLOCK_RESERVE="8", TPUSHARE_KV_BLOCK_LIMIT="32")
    spec = tenant.kv_quota_env()["default"]
    assert (spec.reserve, spec.ceiling) == (8, 32)
    set_env(monkeypatch, TPUSHARE_KV_BLOCK_LIMIT="4")
    with pytest.raises(tenant.AllocationError):
        tenant.kv_quota_env()


# -- the guard -------------------------------------------------------------------

def test_hbm_guard_breach():
    guard = tenant.HbmGuard(limit_bytes=100, interval=0.01,
                            used_bytes_fn=lambda: 500)
    hits = []
    guard.on_breach = lambda used, limit: hits.append((used, limit))
    with guard:
        time.sleep(0.1)
    assert guard.breaches >= 1
    assert hits[0] == (500, 100)


def test_hbm_guard_no_limit_never_starts():
    guard = tenant.HbmGuard(limit_bytes=None)
    guard.start()
    assert guard._thread is None
    guard.stop()


def test_guard_reads_nothing_before_cuda_is_up():
    """Without an injected reader the guard reads the allocator's
    reserved bytes, and only once the process itself has initialized
    CUDA: here it reads 0 and initializes nothing."""
    guard = tenant.HbmGuard(limit_bytes=1)
    assert guard._used_bytes() == 0
    assert not torch.cuda.is_initialized()


def test_hbm_guard_enforce_raises_in_main_thread(restore_enforce_signal):
    assert tenant._install_soft_oom_handler()
    guard = tenant.HbmGuard(limit_bytes=100, interval=0.01, enforce=True,
                            used_bytes_fn=lambda: 500)
    tenant._enforcing_guard = guard
    with pytest.raises(tenant.SoftHbmOom, match="500 bytes of 100"):
        with guard:
            deadline = time.time() + 5.0
            while time.time() < deadline:
                time.sleep(0.01)        # signal lands here
        raise AssertionError("guard never enforced")
    assert guard.breaches >= 1


def test_hbm_guard_enforce_cooldown(restore_enforce_signal):
    hits = []
    assert tenant._install_soft_oom_handler()
    guard = tenant.HbmGuard(limit_bytes=100, interval=0.01, enforce=True,
                            used_bytes_fn=lambda: 500)
    guard.ENFORCE_COOLDOWN_S = 10.0
    tenant._enforcing_guard = guard
    end = time.time() + 0.3
    with guard:
        while time.time() < end:
            try:
                while time.time() < end:
                    time.sleep(0.01)
            except tenant.SoftHbmOom:
                hits.append(time.time())
    assert len(hits) == 1
    assert guard.breaches > 1


def test_apply_limits_starts_enforcing_guard(monkeypatch,
                                             restore_enforce_signal):
    set_env(monkeypatch, **GRANT)
    spec = tenant.apply_tenant_limits()
    assert spec.hbm_limit_bytes == 8 << 30
    guard = tenant.get_enforcing_guard()
    assert guard is not None and guard.enforce and guard._thread is not None
    assert guard.limit == 8 << 30


@pytest.mark.parametrize("mode,armed,enforcing", [
    ("off", False, None), ("log", True, False), ("raise", True, True),
    ("enforced", True, True)])          # an unknown mode fails closed
def test_apply_limits_modes(monkeypatch, restore_enforce_signal, mode,
                            armed, enforcing):
    set_env(monkeypatch, **dict(GRANT, TPUSHARE_HBM_ENFORCE=mode))
    tenant.apply_tenant_limits()
    guard = tenant.get_enforcing_guard()
    assert (guard is not None) == armed
    if armed:
        assert guard.enforce == enforcing


def test_isolation_disabled_arms_nothing(monkeypatch, restore_enforce_signal):
    set_env(monkeypatch, **dict(GRANT, CTPU_DISABLE="true"))
    queued = []
    monkeypatch.setattr(torch.cuda, "_lazy_call",
                        lambda fn, **kw: queued.append(fn))
    spec = tenant.apply_tenant_limits()
    assert spec.isolation_disabled
    assert tenant.get_enforcing_guard() is None and queued == []


def test_apply_limits_off_stops_previous_guard(monkeypatch,
                                               restore_enforce_signal):
    set_env(monkeypatch, **GRANT)
    tenant.apply_tenant_limits()
    first = tenant.get_enforcing_guard()
    assert first is not None and first._thread is not None
    tenant.apply_tenant_limits(enforce="off")
    assert tenant.get_enforcing_guard() is None
    assert first._stop.is_set()


def test_direct_enforce_guard_installs_handler(restore_enforce_signal):
    signal.signal(tenant._ENFORCE_SIGNAL, signal.SIG_DFL)
    guard = tenant.HbmGuard(limit_bytes=100, interval=0.01, enforce=True,
                            used_bytes_fn=lambda: 500)
    with pytest.raises(tenant.SoftHbmOom):
        with guard:
            deadline = time.time() + 5.0
            while time.time() < deadline:
                time.sleep(0.01)
        raise AssertionError("guard never enforced")


def test_apply_limits_passes_the_reader_to_the_guard(monkeypatch,
                                                     restore_enforce_signal):
    set_env(monkeypatch, **dict(GRANT, TPUSHARE_HBM_LIMIT_BYTES="100"))
    tenant.apply_tenant_limits(enforce="log", used_bytes_fn=lambda: 7)
    assert tenant.get_enforcing_guard()._used_bytes() == 7


# -- the card's half, on the CPU ---------------------------------------------------

def test_import_and_apply_initialize_no_cuda():
    """A fresh interpreter: importing the module and applying a grant
    queue the fraction and start the guard, and CUDA stays down."""
    code = (
        "import torch\n"
        "from tpushare_torch.utils import tenant\n"
        "spec = tenant.apply_tenant_limits()\n"
        "assert tenant.get_enforcing_guard() is not None\n"
        "assert not torch.cuda.is_initialized()\n"
        "print(len(torch.cuda._queued_calls), spec.chips)\n")
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env.update(GRANT, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, chips = out.stdout.split(maxsplit=1)
    assert int(n) >= 1 and chips.strip() == "[0]"


def test_fraction_is_queued_per_card_from_the_limit(monkeypatch,
                                                    restore_enforce_signal):
    """The queued call caps each visible card at limit / cards of its
    own total_memory (not the unit ratio: 79 units are not the card's
    79.18 GiB)."""
    set_env(monkeypatch, **dict(GRANT, TPUSHARE_HBM_ENFORCE="off"))
    queued, applied = [], []
    monkeypatch.setattr(torch.cuda, "_lazy_call",
                        lambda fn, **kw: queued.append(fn))
    tenant.apply_tenant_limits()
    assert len(queued) == 1 and not torch.cuda.is_initialized()

    class Props:
        total_memory = 85017493504         # an H100 80GB HBM3's
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props)
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                        lambda f, device=None: applied.append((device, f)))
    queued[0]()
    frac = (8 << 30) / 2 / 85017493504
    assert applied == [(0, frac), (1, frac)]
    applied.clear()
    tenant._apply_fraction(200 << 30)        # more than the cards hold
    assert applied == [(0, 1.0), (1, 1.0)]


def test_tenant_device_initializes_cuda(monkeypatch):
    called = []
    monkeypatch.setattr(torch.cuda, "init", lambda: called.append(1))
    assert tenant.tenant_device() == torch.device("cuda", 0)
    assert called == [1]


@pytest.mark.parametrize("grant,cards,existing,want", [
    ("2", 4, None, 2),           # bare process, 4 cards: mirror card 2
    ("0,3", 4, None, (0, 3)),
    ("0", 1, None, None),        # the container's one card: CUDA device 0
    ("1", 1, None, None),        # host index 1 exposed as the only card
    ("2", 4, "1", None),         # someone chose already
])
def test_mirroring_rule(monkeypatch, grant, cards, existing, want):
    set_env(monkeypatch, NVIDIA_VISIBLE_DEVICES=grant)
    if existing is not None:
        set_env(monkeypatch, CUDA_VISIBLE_DEVICES=existing)
    fake = FakeNvml(_cards(cards))
    spec = tenant.read_tenant_env()
    got = tenant.mirror_visible_cards(spec, nvml_lib=fake)
    if want is None:
        assert got is None
        assert os.environ.get("CUDA_VISIBLE_DEVICES") == existing
    else:
        idx = (want,) if isinstance(want, int) else want
        value = ",".join(_cards(cards)[i]["uuid"] for i in idx)
        assert got == value == os.environ["CUDA_VISIBLE_DEVICES"]
        assert fake.calls == ["init", "shutdown"]


def test_mirroring_needs_the_plugins_selector(monkeypatch):
    """A TPU-style grant or no NVML mirrors nothing."""
    set_env(monkeypatch, TPU_VISIBLE_CHIPS="2")
    spec = tenant.read_tenant_env()
    assert tenant.mirror_visible_cards(spec, FakeNvml(_cards(4))) is None
    set_env(monkeypatch, NVIDIA_VISIBLE_DEVICES="2")
    spec = tenant.read_tenant_env()
    fake = FakeNvml(_cards(4), init_rc=9)
    assert tenant.mirror_visible_cards(spec, fake) is None
    assert "CUDA_VISIBLE_DEVICES" not in os.environ


def test_apply_limits_mirrors_through_nvml(monkeypatch,
                                           restore_enforce_signal):
    set_env(monkeypatch, **dict(GRANT, NVIDIA_VISIBLE_DEVICES="3",
                                TPUSHARE_HBM_ENFORCE="off"))
    monkeypatch.setattr(torch.cuda, "_lazy_call", lambda fn, **kw: None)
    spec = tenant.apply_tenant_limits(nvml_lib=FakeNvml(_cards(4)))
    assert spec.chips == [3]
    assert os.environ["CUDA_VISIBLE_DEVICES"] == _cards(4)[3]["uuid"]
