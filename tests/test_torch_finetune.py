"""The port's fine-tuning half against the JAX package's, on the CPU in
f32: the data pipeline (``utils/data.py``), safetensors checkpoints
(``utils/checkpoint.py``), the trainer's checkpoint/resume
(``models/trainer.py``), LoRA training (``models/lora.py``), the
Hugging Face converters (``models/convert.py``) and the lifecycle tool
(``tools/finetune_serve.py``).

Tolerances: batches byte-equal; checkpoints and resumed runs bit-equal
(``torch.equal``); LoRA losses within 1e-5 relative of JAX's and updated
adapters within 2e-6 abs (the two libraries sum the same products in
other orders); converted models' logits within 2e-4 of ``transformers``'
(the JAX package's own ``tests/test_convert.py`` limit) and equal to the
JAX converter's params bit for bit.
"""

import json
import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import lora as jl
from tpushare.models import training as jtr
from tpushare.models import transformer as jt
from tpushare.utils import data as jdata

from tpushare_torch.models import bridge, lora, trainer
from tpushare_torch.models import training as ttr
from tpushare_torch.models import transformer as tt
from tpushare_torch.utils import checkpoint
from tpushare_torch.utils import data as tdata

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: these are small tensors, and
    under a loaded pytest-xdist run torch's default of one thread per
    core oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(n=3000, vocab=97, seed=5):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.uint16)


class TestData:
    @pytest.mark.parametrize("shuffle", [True, False])
    @pytest.mark.parametrize("seed", [0, 3])
    def test_batches_byte_equal_including_resume(self, seed, shuffle):
        """Every (seed, step) batch, through three epochs, and the stream
        resumed at steps 0, 5 and 11, equal to the JAX package's byte for
        byte."""
        toks = _corpus()
        kw = dict(batch_size=4, seq_len=16, seed=seed, shuffle=shuffle)
        n = 3 * tdata.n_windows(len(toks), 16) // 4
        for step in range(0, n, 7):
            got = tdata.batch_at(toks, step, **kw)
            want = jdata.batch_at(toks, step, **kw)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        for start in (0, 5, 11):
            ts = tdata.token_batches(toks, start_step=start, **kw)
            js = jdata.token_batches(toks, start_step=start, **kw)
            for _ in range(n - start):
                assert next(ts).tobytes() == next(js).tobytes()

    def test_memmap_and_refusals_match(self, tmp_path):
        toks = _corpus(n=700)
        path = str(tmp_path / "corpus.bin")
        toks.tofile(path)
        assert np.array_equal(tdata.load_tokens(path), jdata.load_tokens(path))
        with open(path, "ab") as f:
            f.write(b"\0")
        for mod in (tdata, jdata):
            with pytest.raises(ValueError, match="multiple"):
                mod.load_tokens(path)
            with pytest.raises(ValueError, match="window"):
                mod.batch_at(np.arange(8, dtype=np.uint16), 0, batch_size=1,
                             seq_len=16)
        assert tdata.n_windows(161, 16) == jdata.n_windows(161, 16) == 10


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(3, 5, generator=g).to(torch.bfloat16),
                   "q": {"w#q8": torch.randint(-128, 128, (4, 6),
                                               dtype=torch.int8, generator=g),
                         "w#scale": torch.rand(1, 6, generator=g)}},
        "opt_state": {"count": torch.tensor(7, dtype=torch.int32),
                      "empty": {}},
        "step": torch.tensor(3, dtype=torch.int32),
        "ids": torch.arange(10, dtype=torch.int64).reshape(2, 5),
        "mask": torch.tensor([True, False, True]),
    }


def _equal_trees(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert torch.equal(a[k], b[k]), k


class TestCheckpoint:
    def test_roundtrip_exact_bf16_int8_0d_and_empty(self, tmp_path):
        tree = _tree()
        path = str(tmp_path / "ck")
        n = checkpoint.save(path, tree)
        assert n == os.path.getsize(path)
        _equal_trees(checkpoint.restore(path, device="cpu"), tree)
        _equal_trees(checkpoint.restore(path, like=tree), tree)

    def test_the_file_is_safetensors(self, tmp_path):
        """The layout by hand (8-byte length, padded JSON header, dtype /
        shape / offsets per key), and the safetensors package, where the
        environment has it, reads the same tensors."""
        tree = _tree(1)
        path = str(tmp_path / "ck")
        checkpoint.save(path, tree)
        raw = open(path, "rb").read()
        (n,) = struct.unpack("<Q", raw[:8])
        assert n % 8 == 0
        header = json.loads(raw[8:8 + n])
        info = header["params/w"]
        assert info["dtype"] == "BF16" and info["shape"] == [3, 5]
        assert header["step"]["shape"] == []
        assert json.loads(header["__metadata__"]["tree"])["opt_state"] == {
            "count": None, "empty": {}}
        st = pytest.importorskip("safetensors.torch")
        loaded = st.load_file(path)
        for key, t in checkpoint.key_paths(tree):
            assert torch.equal(loaded[key], t), key

    def test_like_fixes_dtype_and_device_and_mismatches_raise(self, tmp_path):
        tree = _tree(2)
        path = str(tmp_path / "ck")
        checkpoint.save(path, tree)
        like = _tree(2)
        like["params"]["w"] = like["params"]["w"].float()
        back = checkpoint.restore(path, like=like)
        assert back["params"]["w"].dtype == torch.float32
        assert torch.equal(back["params"]["w"], tree["params"]["w"].float())
        bad = _tree(2)
        bad["params"]["w"] = torch.zeros(3, 6)
        with pytest.raises(ValueError, match="params/w: shape"):
            checkpoint.restore(path, like=bad)
        bad = _tree(2)
        bad["params"]["extra"] = torch.zeros(1)
        with pytest.raises(ValueError, match="params/extra: missing"):
            checkpoint.restore(path, like=bad)
        with pytest.raises(NotImplementedError, match="A10"):
            checkpoint.restore(path, like=tree, shardings=object())

    def test_overwrite_behaves_as_the_reference(self, tmp_path):
        """overwrite=True (the default) replaces; overwrite=False on an
        existing path raises ValueError, as orbax's save does; no
        temporary file is left behind."""
        path = str(tmp_path / "ck")
        checkpoint.save(path, {"step": torch.tensor(1)})
        checkpoint.save(path, {"step": torch.tensor(2)})
        assert int(checkpoint.restore(path, device="cpu")["step"]) == 2
        with pytest.raises(ValueError, match="already exists"):
            checkpoint.save(path, {"step": torch.tensor(3)}, overwrite=False)
        assert int(checkpoint.restore(path, device="cpu")["step"]) == 2
        assert os.listdir(tmp_path) == ["ck"]

    def test_quantized_tree_roundtrips(self, tmp_path):
        from tpushare_torch.models import quant
        cfg = tt.tiny(n_layers=1)
        qp = quant.quantize_params(tt.init_params(0, cfg, device="cpu"), cfg)
        path = str(tmp_path / "qp")
        checkpoint.save(path, qp)
        back = checkpoint.restore(path, like=qp)
        assert back["layers"]["wq#q8"].dtype == torch.int8
        _equal_trees(back, qp)


CFG_J = jt.tiny(remat=False)


def _jbatches(n, batch=2, seq=17, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG_J.vocab_size, (batch, seq)) for _ in range(n)]


def _clone(tree):
    return ttr.tree_map(lambda t: t.clone(), tree)


class TestTrainer:
    @pytest.mark.parametrize("opt", ["sgd", "adamw"])
    def test_interrupted_equals_uninterrupted(self, tmp_path, opt):
        """The counterpart of tests/test_trainer.py's resume tests: 6
        steps straight, against 3 steps with a checkpoint, a restore and
        3 more, params, state and losses bit for bit; the JAX loop on
        the same bridged weights and data within the stated tolerance."""
        cfg = bridge.config_from_jax(CFG_J)
        jp0 = jt.init_params(jax.random.PRNGKey(0), CFG_J)
        p0 = bridge.params_from_jax(jp0, device="cpu")
        data = [torch.tensor(b) for b in _jbatches(6)]
        if opt == "sgd":
            def step(p, o, tok):
                p, loss = ttr.sgd_train_step(p, tok, cfg, lr=0.05)
                return p, o, loss
            o0 = {}
        else:
            def step(p, o, tok):
                return ttr.adamw_train_step(p, o, tok, cfg, lr=1e-2)
            o0 = ttr.adamw_init(p0)
        p_ref, o_ref, losses_ref = trainer.fit(step, _clone(p0), _clone(o0),
                                               data, steps=6, log_every=0)
        ckpt = str(tmp_path / "ckpts")
        trainer.fit(step, _clone(p0), _clone(o0), data, steps=3,
                    ckpt_dir=ckpt, ckpt_every=3, log_every=0)
        path = trainer.latest_checkpoint(ckpt)
        assert path.endswith("step_3")
        p2, o2, start = trainer.load_state(path, like_params=p0, like_opt=o0)
        assert start == 3
        p_fin, o_fin, losses2 = trainer.fit(step, p2, o2, data[3:], steps=6,
                                            start_step=3, log_every=0)
        _equal_trees(p_fin, p_ref)
        _equal_trees(o_fin, o_ref)
        assert [float(x) for x in losses2] == [float(x)
                                               for x in losses_ref[3:]]
        # The JAX loop on the same weights and batches.
        if opt == "sgd":
            jstep = jax.jit(lambda p, t: jtr.sgd_train_step(p, t, CFG_J,
                                                            lr=0.05))
            jp = jp0
            for b, want in zip(_jbatches(6), losses_ref):
                jp, jloss = jstep(jp, jnp.asarray(b))
                np.testing.assert_allclose(float(want), float(jloss),
                                           rtol=LOSS_RTOL)
            for key, w in _flat(jax.tree.map(np.asarray, jp)).items():
                np.testing.assert_allclose(_flat(p_fin)[key], w, rtol=0,
                                           atol=PARAM_ATOL)

    def test_latest_checkpoint_and_the_step_leaf(self, tmp_path):
        assert trainer.latest_checkpoint(str(tmp_path / "none")) is None
        os.makedirs(tmp_path / "d")
        assert trainer.latest_checkpoint(str(tmp_path / "d")) is None
        cfg = tt.tiny()
        p = tt.init_params(0, cfg, device="cpu")
        for n in (2, 10, 7):
            trainer.save_state(str(tmp_path / "d" / f"step_{n}"), p, {}, n)
        (tmp_path / "d" / "step_x").write_text("")
        path = trainer.latest_checkpoint(str(tmp_path / "d"))
        assert path.endswith("step_10")
        back, opt, step = trainer.load_state(path, like_params=p, like_opt={})
        assert step == 10 and opt == {}
        _equal_trees(back, p)
        with pytest.raises(NotImplementedError, match="A10"):
            trainer.load_state(path, like_params=p, like_opt={},
                               shardings={"params": object()})

    def test_fit_with_the_data_pipeline_resumes_exactly(self, tmp_path):
        """token_batches(start_step=k) positions the stream, so the
        resumed run consumes exactly the batches the uninterrupted one
        did (tests/test_trainer.py's test_resume_with_data_pipeline)."""
        cfg = tt.tiny(remat=False)
        p0 = tt.init_params(0, cfg, device="cpu")
        corpus = np.random.default_rng(4).integers(
            0, cfg.vocab_size, 4000).astype(np.uint16)
        kw = dict(batch_size=2, seq_len=16, seed=11)

        def batches(start=0):
            for b in tdata.token_batches(corpus, start_step=start, **kw):
                yield torch.from_numpy(b)

        def step(p, o, tok):
            return ttr.adamw_train_step(p, o, tok, cfg, lr=1e-2)
        p_ref, o_ref, _ = trainer.fit(step, _clone(p0), ttr.adamw_init(p0),
                                      batches(), steps=6, log_every=0)
        p1, o1, _ = trainer.fit(step, _clone(p0), ttr.adamw_init(p0),
                                batches(), steps=3, log_every=0)
        trainer.save_state(str(tmp_path / "ck"), p1, o1, 3)
        p2, o2, start = trainer.load_state(str(tmp_path / "ck"),
                                           like_params=p0,
                                           like_opt=ttr.adamw_init(p0))
        p_fin, o_fin, _ = trainer.fit(step, p2, o2, batches(start), steps=6,
                                      start_step=start, log_every=0)
        _equal_trees(p_fin, p_ref)
        _equal_trees(o_fin, o_ref)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.detach().numpy() if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    return out


def _jax_adapter(seed, rank=4):
    ad = jl.init_lora(jax.random.PRNGKey(seed), CFG_J, rank)
    rng = np.random.default_rng(seed)
    return {n: {"a": ab["a"], "b": jnp.asarray(rng.normal(
        size=ab["b"].shape).astype(np.float32) * 0.3)}
        for n, ab in ad.items()}


class TestLoraTraining:
    def test_loss_and_step_match_jax_and_base_gets_no_grad(self):
        """lora_loss and three lora_train_steps against the JAX
        package's on bridged base and adapters (B non-zero, so both
        factors move); the base's tensors never get a gradient."""
        jp = jt.init_params(jax.random.PRNGKey(1), CFG_J)
        jad = _jax_adapter(2)
        cfg = bridge.config_from_jax(CFG_J)
        base = bridge.params_from_jax(jp, device="cpu")
        for t in ttr.tree_leaves(base):
            t.requires_grad_(False)
        ads = bridge.adapters_from_jax(jad, device="cpu")
        toks = _jbatches(3, seed=3)
        want = jl.lora_loss(jp, jad, jnp.asarray(toks[0]), CFG_J)
        got = lora.lora_loss(base, ads, torch.tensor(toks[0]), cfg)
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
        for tok in toks:
            jad, jloss = jl.lora_train_step(jp, jad, jnp.asarray(tok), CFG_J,
                                            lr=0.1)
            ads, tloss = lora.lora_train_step(base, ads, torch.tensor(tok),
                                              cfg, lr=0.1)
            np.testing.assert_allclose(float(tloss), float(jloss),
                                       rtol=LOSS_RTOL)
        for key, w in _flat(jax.tree.map(np.asarray, jad)).items():
            np.testing.assert_allclose(_flat(ads)[key], w, rtol=0,
                                       atol=PARAM_ATOL)
        assert all(t.grad is None and not t.requires_grad
                   for t in ttr.tree_leaves(base))
        assert all(t.dtype == torch.float32 and not t.requires_grad
                   for t in ttr.tree_leaves(ads))

    def test_fit_step_resumes_bit_exact(self, tmp_path):
        """make_lora_fit_step through trainer.fit: a LoRA tenant
        preempted at step 4 resumes to the uninterrupted adapters."""
        cfg = tt.tiny(remat=True)
        base = tt.init_params(0, cfg, device="cpu")
        ad0 = lora.init_lora(torch.Generator().manual_seed(3), cfg, 4)
        step = lora.make_lora_fit_step(base, cfg, lr=0.3)
        data = [torch.tensor(b) for b in _jbatches(8, seed=5)]
        want, _, _ = trainer.fit(step, _clone(ad0), {}, data, steps=8,
                                 log_every=0)
        trainer.fit(step, _clone(ad0), {}, data, steps=4,
                    ckpt_dir=str(tmp_path), ckpt_every=4, log_every=0)
        back, opt, start = trainer.load_state(
            trainer.latest_checkpoint(str(tmp_path)), like_params=ad0,
            like_opt={})
        got, _, _ = trainer.fit(step, back, opt, data[start:], steps=8,
                                start_step=start, log_every=0)
        _equal_trees(got, want)

    def test_left_out_piece_names_its_item(self, tmp_path):
        """The adapters' placement is ported (ROADMAP A10a): its spec
        tree equals the reference's; and since A10b no checkpoint
        placement is left out: a tree saved whole restores as a tp
        rank's slices (``MeshShard``), and an unknown placement is a
        TypeError."""
        jcfg = jt.tiny()
        targets = ("wq", "wv", "wo", "w_down")
        want = jl.lora_param_specs(jcfg, targets, fsdp="fsdp")
        got = lora.lora_param_specs(bridge.config_from_jax(jcfg), targets,
                                    fsdp="fsdp")
        assert {n: {k: tuple(v) for k, v in ab.items()}
                for n, ab in got.items()} == \
            {n: {k: tuple(v) for k, v in ab.items()}
             for n, ab in want.items()}
        path = str(tmp_path / "ck")
        tree = {"w": torch.arange(8.0).reshape(2, 4)}
        checkpoint.save(path, tree)
        from tpushare_torch.parallel.mesh import ServingMesh
        from tpushare_torch.parallel.sharding import P
        mesh = ServingMesh({"tp": 2}, ["cpu"] * 2)
        for r in range(2):
            mesh.rank = r
            got = checkpoint.restore(path, device="cpu",
                                     shardings=checkpoint.mesh_shardings(
                                         {"w": P(None, "tp")}, mesh))
            assert torch.equal(got["w"], tree["w"][:, 2 * r:2 * r + 2])
        with pytest.raises(NotImplementedError, match="MeshShard"):
            checkpoint.restore(path, like=tree, shardings=object())


def _hf_models():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    llama = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-6, rope_theta=10000.0,
        tie_word_embeddings=False, attn_implementation="eager")).eval()
    gemma2 = transformers.Gemma2ForCausalLM(transformers.Gemma2Config(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=64, sliding_window=8,
        query_pre_attn_scalar=16, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, attn_implementation="eager")).eval()
    return {"llama": llama, "gemma2": gemma2}


class TestConvert:
    @pytest.mark.parametrize("name", ["llama", "gemma2"])
    def test_from_hf_matches_transformers_and_jax(self, name):
        from tpushare.models import convert as jconvert
        from tpushare_torch.models import convert
        model = _hf_models()[name]
        params, cfg = convert.from_hf(model, dtype=torch.float32,
                                      device="cpu")
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
        with torch.no_grad():
            want = model(torch.tensor(toks)).logits.float().numpy()
            got, _ = tt.forward(params, torch.tensor(toks), cfg)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
        jparams, jcfg = jconvert.from_hf(model, dtype=jnp.float32)
        assert bridge.config_from_jax(jcfg) == cfg
        jflat = _flat(jax.tree.map(np.asarray, jparams))
        flat = _flat(params)
        assert sorted(jflat) == sorted(flat)
        for key in flat:
            assert np.array_equal(flat[key], jflat[key]), key
        # A raw state dict needs its config.
        with pytest.raises(ValueError, match="hf_cfg"):
            convert.from_hf(model.state_dict(), device="cpu")

    def test_moe_from_hf_matches_transformers_and_jax(self):
        from tpushare.models import convert as jconvert
        from tpushare_torch.models import convert, moe
        transformers = pytest.importorskip("transformers")
        torch.manual_seed(0)
        hcfg = transformers.MixtralConfig(
            vocab_size=96, hidden_size=64, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, num_local_experts=4,
            num_experts_per_tok=2, max_position_embeddings=64,
            sliding_window=None, attn_implementation="eager")
        model = transformers.MixtralForCausalLM(hcfg).eval()
        params, cfg = convert.moe_from_hf(model, dtype=torch.float32,
                                          device="cpu")
        toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 10))
        with torch.no_grad():
            want = model(torch.tensor(toks)).logits.float().numpy()
            got, _ = moe.forward(params, torch.tensor(toks), cfg)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
        jparams, _ = jconvert.moe_from_hf(model, dtype=jnp.float32)
        jflat = _flat(jax.tree.map(np.asarray, jparams))
        for key, arr in _flat(params).items():
            assert np.array_equal(arr, jflat[key]), key
        hcfg.sliding_window = 16
        with pytest.raises(NotImplementedError, match="sliding_window"):
            convert.moe_from_hf(model.state_dict(), hcfg, device="cpu")


def test_finetune_serve_tool_exits_zero(tmp_path):
    """``python -m tpushare_torch.tools.finetune_serve --device cpu
    --tiny`` as a subprocess: the demo's assertions hold (each tenant's
    completion follows its adapter, the base's does not, B's resume is
    bit-equal), exit 0."""
    # One intra-op thread: under a loaded pytest-xdist run, torch's
    # default of one thread per core oversubscribes the host and the
    # engine's threads spin against each other.
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("NVIDIA_", "CUDA_VISIBLE", "TPUSHARE_",
                                "CTPU_"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.tools.finetune_serve",
         "--device", "cpu", "--tiny", "--workdir", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["failures"] == []
    assert rec["tenants"]["b"]["resume_equal"] is True
    assert rec["tenants"]["b"]["preempted_at"] == rec["steps"] // 2
    toks = rec["served"]["tokens"]
    assert toks["a"].count(7) >= 3 and toks["b"].count(42) >= 3
    assert os.path.exists(os.path.join(str(tmp_path), "b",
                                       f"step_{rec['steps']}"))
