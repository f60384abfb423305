"""The port's in-process C embedding API (rten_tpu_torch/native/embed_api.cpp,
built by ``native.build.build_embed``) and the JS client's contract
against the port's HTTP server.

A C program (``chip_smoke.EMBED_DRIVER_C``, the JAX package's
tests/test_embed_api.py driver) is compiled with g++ and linked against the
port's librten_embed.so; with RTEN_TORCH_DEVICE=cpu it loads a .rten from
disk and runs it, and its output equals numpy's and the JAX package's
``Model`` on the same file, in-process, within 1e-5. RTEN_TORCH_DEVICE=tpu,
or cuda on a machine without a card, makes rten_init fail with its reason
(no fallback to the CPU); a missing file gives NULL and a reason.

js/rten_client.js's requests (paths and JSON keys read from the file) go to
a ServingServer over a CPU ServingEngine on loopback; the replies carry the
keys the client reads, and a refused request answers 400 with ``error``.
"""

import json
import re
import shutil
import sysconfig
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
    if shutil.which("g++") is None or not (Path(sysconfig.get_paths()["include"]) / "Python.h").exists():
        pytest.skip("g++ or Python.h is missing")
    tmp = tmp_path_factory.mktemp("embed")
    model = tmp / "embed_test.rten"
    return chip_smoke.build_embed_driver(tmp), model, chip_smoke.embed_model(model)


def test_build_embed_goes_into_build_dir():
    """The library lands under rten_tpu_torch/_build/embed-<hash>/ and a
    second call reuses it."""
    from rten_tpu_torch.native import build

    if build.build_embed() is None:
        pytest.skip("g++ or Python.h is missing")
    path = build.build_embed()
    assert path.parent.parent == REPO / "rten_tpu_torch" / "_build" and path.parent.name.startswith("embed-")
    assert path.name == "librten_embed.so" and path == build.embed_lib_path() and path.exists()


def test_c_program_runs_model_on_cpu(driver):
    from rten_tpu import Model as JaxModel

    exe, model, wv = driver
    got = chip_smoke.embed_output(chip_smoke.run_embed_driver(exe, str(model), "cpu"))
    x = chip_smoke.embed_input()
    np.testing.assert_allclose(got, np.maximum(x @ wv, 0) + 1.0, rtol=1e-5, atol=1e-5)
    want = np.asarray(JaxModel.load_file(str(model)).run([x])[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_missing_file_gives_null_and_reason(driver, tmp_path):
    exe, _, _ = driver
    proc = chip_smoke.run_embed_driver(exe, str(tmp_path / "missing.rten"), "cpu")
    assert proc.returncode == 3, proc.stderr  # rten_model_load_file returned NULL
    reason = proc.stderr.strip().split("load failed: ", 1)[1]
    assert reason and "missing.rten" in reason


@pytest.mark.parametrize("device", ["tpu", "cuda"])
def test_init_refuses_other_devices(driver, device):
    """RTEN_TORCH_DEVICE=tpu, or cuda without a card, makes rten_init fail
    with its reason; nothing falls back to the CPU."""
    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    exe, model, _ = driver
    proc = chip_smoke.run_embed_driver(exe, str(model), device)
    assert proc.returncode == 1 and proc.stdout == ""
    reason = proc.stderr.strip().split("init failed: ", 1)[1]
    assert ("'tpu'" in reason) if device == "tpu" else ("CUDA is not available" in reason)


# ---------------------------------------------------------------------------
# js/rten_client.js against the port's ServingServer
# ---------------------------------------------------------------------------


def _client_contract():
    """The client's request paths, the POST body's keys, and the reply keys
    its JSDoc says it reads, from js/rten_client.js."""
    src = (REPO / "js" / "rten_client.js").read_text(encoding="utf-8")
    paths = set(re.findall(r'_request\("(/\w+)"', src))
    body = re.search(r"JSON\.stringify\(\{(.*?)\}\)", src, re.S).group(1)
    body_keys = set(re.findall(r"^\s*([A-Za-z_]\w*)\s*(?::|,)", body, re.M))
    returns = re.findall(r"@returns \{Promise<\{(.*?)\}>\}", src)
    reply_keys = [set(re.findall(r"(\w+):", r)) for r in returns]
    return src, paths, body_keys, reply_keys


def _http(url, body=None):
    """(status, JSON reply) of a GET, or a POST of ``body`` as the client
    sends it."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"},
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_js_client_contract_against_port_server():
    from rten_tpu_torch.models import decoder
    from rten_tpu_torch.serve import ServingEngine, ServingServer

    src, paths, body_keys, (gen_keys, health_keys, *_) = _client_contract()
    assert paths == {"/generate", "/healthz", "/stats"}
    assert body_keys == {"prompt", "max_new_tokens", "eos"} and "body.error" in src
    assert gen_keys == {"request_id", "tokens", "finished"} and health_keys == {"status", "active", "queued", "steps"}

    cfg = decoder.DecoderConfig(vocab_size=300, n_layers=1, n_heads=4, d_model=256, d_ff=512, max_seq=64,
                                dtype=torch.float32)
    params = decoder.quantize_params_int8(decoder.init_params(0, cfg, device="cpu"), device="cpu")
    server = ServingServer(ServingEngine(params, cfg, max_batch=2, device="cpu"))
    server.start()
    try:
        url = f"http://127.0.0.1:{server.port}"
        status, health = _http(url + "/healthz")
        assert status == 200 and health_keys <= set(health) and health["status"] == "ok"
        # client.generate([464, 2068, 7586], {maxNewTokens: 4, eos: []}): the body it sends.
        status, reply = _http(url + "/generate", {"prompt": [4, 68, 86], "max_new_tokens": 4, "eos": []})
        assert status == 200 and set(reply) == gen_keys
        assert reply["finished"] and len(reply["tokens"]) == 4 and all(isinstance(t, int) for t in reply["tokens"])
        status, stats = _http(url + "/stats")
        assert status == 200 and stats["steps"] > 0
        status, _ = _http(url + "/generate", {"prompt": [1, 2], "max_new_tokens": 8, "eos": [reply["tokens"][0]]})
        assert status == 200
        for bad in ({"prompt": ["x"], "max_new_tokens": 4, "eos": []},  # not token ids
                    {"max_new_tokens": 4, "eos": []},  # no prompt
                    {"prompt": list(range(60)), "max_new_tokens": 32, "eos": []}):  # past max_seq
            status, reply = _http(url + "/generate", bad)
            assert status == 400 and reply["error"], bad  # the client throws RtenServerError(body.error)
    finally:
        server.stop()
