"""Mesh sharding over a torch ``DeviceMesh`` (``sharding.specs``).

Two surfaces, as in the JAX package:

* the client axis of the federated engine: cohort rows split into
  per-rank slices, cross-client reductions as local partial sums plus
  one ``all_reduce``, everything else replicated, with every rank's own
  float segment sums in a fixed order; a placement relaxes to
  replicated where the rows do not divide the mesh, so results never
  depend on the mesh size;
* the LLM parameter rule table on a ``(data, model)`` mesh
  (``ShardCtx`` / ``shard`` / ``param_shardings`` / ``unshard_fsdp``):
  the reference's specs as DTensor placements, relaxed where an axis
  does not divide, and the hooks the models call at the reference's
  sites (no-ops without an entered ``ShardCtx``).
"""
from repro_torch.sharding.specs import (  # noqa: F401
    PARAM_RULES,
    CollectiveLog,
    NamedSharding,
    RowOwners,
    RowSplit,
    ShardCtx,
    align_cohort_chunk,
    all_reduce_,
    barrier,
    client_axes,
    cohort_spec,
    constrain_cohort,
    current_ctx,
    local_channels,
    local_experts,
    merge_heads,
    mesh_backend,
    mesh_client_count,
    mesh_device,
    mesh_fingerprint,
    mesh_group,
    mesh_rank,
    model_axis_blocker,
    ordered_index_add_,
    param_shardings,
    place_buffer_rows,
    place_cohort,
    place_decode_state,
    place_params,
    place_replicated,
    placements,
    psum_segments,
    relax,
    replicated,
    row_owners,
    row_split,
    segment_sum,
    shard,
    spec_for_path,
    split_heads,
    to_local,
    unshard_fsdp,
    wrap_like,
)

__all__ = ["PARAM_RULES", "CollectiveLog", "NamedSharding", "RowOwners", "RowSplit",
           "ShardCtx", "align_cohort_chunk", "all_reduce_", "barrier", "client_axes",
           "cohort_spec", "constrain_cohort", "current_ctx", "local_channels",
           "local_experts", "merge_heads", "mesh_backend", "mesh_client_count",
           "mesh_device", "mesh_fingerprint", "mesh_group", "mesh_rank",
           "model_axis_blocker", "ordered_index_add_", "param_shardings",
           "place_buffer_rows", "place_cohort", "place_decode_state", "place_params",
           "place_replicated", "placements", "psum_segments", "relax", "replicated",
           "row_owners", "row_split", "segment_sum", "shard", "spec_for_path",
           "split_heads", "to_local", "unshard_fsdp", "wrap_like"]
