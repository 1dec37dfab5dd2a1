"""Backend selection (--backend auto) and device start-up."""

import pytest


def _reset():
    import ribbit_tpu.backend as b
    b._cached = None
    return b


def test_explicit_choices_pass_through(cpu_jax, monkeypatch):
    b = _reset()
    monkeypatch.delenv("RIBBIT_BACKEND", raising=False)
    assert b.resolve_backend("host") == "host"
    assert b.resolve_backend("device") == "device"


def test_auto_without_tpu_backend_is_host(cpu_jax, monkeypatch):
    b = _reset()
    monkeypatch.delenv("RIBBIT_BACKEND", raising=False)
    # the suite forces the CPU platform, so auto must land on host
    assert b.resolve_backend("auto", quiet=True) == "host"


@pytest.mark.parametrize("platform,choice", [
    ("gpu", "device"), ("cpu", "host"), ("tpu", "host")])
def test_auto_follows_jax_platform(cpu_jax, monkeypatch, capsys, platform,
                                   choice):
    """auto is 'device' exactly when JAX's default backend is a GPU, and
    prints what it chose."""
    b = _reset()
    monkeypatch.delenv("RIBBIT_BACKEND", raising=False)
    monkeypatch.setattr(cpu_jax, "default_backend", lambda: platform)
    assert b.resolve_backend("auto") == choice
    assert f"auto -> {choice}" in capsys.readouterr().err


def test_auto_env_override(cpu_jax, monkeypatch):
    b = _reset()
    monkeypatch.setenv("RIBBIT_BACKEND", "device")
    assert b.resolve_backend("auto", quiet=True) == "device"
    monkeypatch.setenv("RIBBIT_BACKEND", "host")
    assert b.resolve_backend("auto", quiet=True) == "host"


def test_auto_choice_is_cached(cpu_jax, monkeypatch):
    """The platform is asked once per process."""
    b = _reset()
    monkeypatch.delenv("RIBBIT_BACKEND", raising=False)
    monkeypatch.setattr(cpu_jax, "default_backend", lambda: "gpu")
    assert b.resolve_backend("auto", quiet=True) == "device"
    monkeypatch.setattr(cpu_jax, "default_backend",
                        lambda: (_ for _ in ()).throw(AssertionError))
    assert b.resolve_backend("auto", quiet=True) == "device"
    _reset()


def test_auto_platform_failure_is_host(cpu_jax, monkeypatch):
    """auto on a process whose JAX platform does not initialise is host."""
    b = _reset()
    monkeypatch.delenv("RIBBIT_BACKEND", raising=False)

    def broken():
        raise RuntimeError("Unable to initialize backend 'cuda'")
    monkeypatch.setattr(cpu_jax, "default_backend", broken)
    assert b.resolve_backend("auto", quiet=True) == "host"
    _reset()


def test_device_init_failure_exits_nonzero(cpu_jax, golden_dir, tmp_path,
                                           monkeypatch, capsys):
    """An explicit --backend device whose JAX platform does not initialise
    ends the run with a non-zero exit and writes no output."""
    from ribbit_tpu.cli import main

    def broken():
        raise RuntimeError("Unable to initialize backend 'cuda'")
    monkeypatch.setattr(cpu_jax, "default_backend", broken)
    out = tmp_path / "out.bed"
    rc = main(["-i", str(golden_dir / "g3.fa"), "-o", str(out),
               "--backend", "device"])
    assert rc != 0
    assert not out.exists()
    assert "did not initialise" in capsys.readouterr().err


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_placement(cpu_jax, monkeypatch, tmp_path, env_dir):
    """The device path keeps JAX's compile cache in JAX_COMPILATION_CACHE_DIR
    when set (and sets nothing), else in build/jax_cache of the checkout."""
    import pathlib
    from ribbit_tpu import backend

    repo = pathlib.Path(backend.__file__).resolve().parents[1]
    before = cpu_jax.config.jax_compilation_cache_dir
    try:
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = str(repo / "build" / "jax_cache")
            assert backend.compile_cache_dir() == want
            assert backend.start_device() == "cpu"
            assert cpu_jax.config.jax_compilation_cache_dir == want
        else:
            want = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
            cpu_jax.config.update("jax_compilation_cache_dir", before)
            assert backend.compile_cache_dir() == want
            assert backend.start_device() == "cpu"
            # JAX reads the variable itself; the program sets nothing
            assert cpu_jax.config.jax_compilation_cache_dir == before
    finally:
        cpu_jax.config.update("jax_compilation_cache_dir", before)


def test_cli_auto_resolves_and_keeps_parity(cpu_jax, golden_dir, tmp_path,
                                            capsys):
    """End-to-end: the CLI default (--backend auto) resolves on a CPU-only
    host and produces oracle-identical output."""
    from ribbit_tpu.cli import main
    _reset()
    out = tmp_path / "out.bed"
    rc = main(["-i", str(golden_dir / "g3.fa"), "-o", str(out)])
    assert rc == 0
    expected = (golden_dir / "g3.oracle.bed").read_text()
    assert out.read_text() == expected
