"""The checks of ``test_torch_lm_families.py`` for RecurrentGemma (RG-LRU
with LOCAL attention, at ``n_layers=5``: a period and the remainder) and
Llama-3.2-Vision (cross attention over stub encoder states): logits, the
loss and every leaf's gradient under two remat policies, prefill and a
decode chain, and the int8 KV cache, against the reference at reduced size
on the CPU, float32 compute, tolerance 1e-5."""
import pytest

from test_torch_lm_families import (REMATS, check_int8_kv_cache,
                                    check_logits_fn, check_loss_and_grads,
                                    check_prefill_then_decode)

HERE = ["recurrentgemma-9b", "llama-3.2-vision-90b"]


@pytest.mark.parametrize("arch", HERE)
def test_logits_fn_matches_the_reference(arch):
    check_logits_fn(arch)


@pytest.mark.parametrize("arch", HERE)
@pytest.mark.parametrize("remat", REMATS)
def test_train_loss_and_grads_match_the_reference(arch, remat):
    check_loss_and_grads(arch, remat)


@pytest.mark.parametrize("arch", HERE)
def test_prefill_then_decode_matches_the_reference(arch):
    check_prefill_then_decode(arch)


@pytest.mark.parametrize("arch,S,cache_len", [
    ("recurrentgemma-9b", 20, 28), ("llama-3.2-vision-90b", 10, 16)])
def test_int8_kv_cache_matches_the_reference(arch, S, cache_len):
    check_int8_kv_cache(arch, S, cache_len)
