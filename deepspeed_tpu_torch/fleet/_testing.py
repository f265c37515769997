"""Importable server factories for subprocess-replica tests and drills.

Port of ``deepspeed_tpu/fleet/_testing.py``. ``SubprocessReplica`` launches
``python -m deepspeed_tpu_torch.fleet.subproc --factory module:callable`` —
the factory must be importable from a fresh interpreter, so it cannot live
in a pytest module. This is that module: one tiny server at the JAX
fixtures' widths, fp32, built on the CPU (``device="cpu"``, so it runs the
paged kernels' plain versions and needs no card), with seeded weights.
"""


def tiny_config():
    """The JAX serving fixtures' model: 2 layers, 48 wide, 4/2 heads."""
    import torch

    from ..models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=97, hidden_size=48,
                             intermediate_size=96, num_layers=2, num_heads=4,
                             num_kv_heads=2, max_seq_len=128,
                             dtype=torch.float32, norm="rmsnorm",
                             activation="swiglu")


def tiny_engine_config():
    from ..inference.v2 import RaggedInferenceEngineConfig

    return RaggedInferenceEngineConfig(
        token_budget=16, max_ragged_sequence_count=4, max_chunk_size=8,
        num_kv_blocks=64, kv_block_size=8, max_blocks_per_seq=8,
        dtype="float32")


def make_tiny_server(replica_id: int):
    """A serving-test-sized LLMServer (2-layer toy model, 64 KV blocks) on
    the CPU, its weights seeded with 0."""
    import torch

    torch.set_num_threads(1)
    from ..inference.v2 import InferenceEngineV2
    from ..models import init_params
    from ..serving.server import LLMServer

    cfg = tiny_config()
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    engine = InferenceEngineV2(cfg, params, tiny_engine_config(), device="cpu")
    return LLMServer(engine, replica_id=replica_id)
