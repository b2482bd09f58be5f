def kernel_wrappers() -> dict:
    """Every hand-written kernel wrapper of the port, by name.  Each keeps
    its launch count in ``.launches``: it adds one where it launches its
    CUDA kernel, never on the CPU's plain path."""
    from arks_tpu_torch.ops import moe_kernel as mk
    from arks_tpu_torch.ops import paged_attention as pa
    from arks_tpu_torch.ops import pallas_attention as pl
    return {fn.__name__: fn for fn in (
        pa.paged_kv_update, pa.paged_kv_update_quant,
        pa.paged_mixed_attention, pa.paged_mixed_attention_dense,
        mk.grouped_matmul, pa.paged_decode_attention, pl.kv_cache_update,
        pl.kv_cache_update_quant, pl.ragged_decode_attention)}


def kernel_launches() -> dict[str, int]:
    """Each kernel wrapper's launch count in this process, by name."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}
