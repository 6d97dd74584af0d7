"""Client-axis sharding of the federated engine over a torch ``DeviceMesh``
(``sharding.specs``): cohort rows split into per-rank slices, cross-client
reductions as local partial sums plus one ``all_reduce``, everything else
replicated, with every rank's own float segment sums in a fixed order;
every placement relaxes to replicated where the rows do not
divide the mesh, so results never depend on the mesh size."""
from repro_torch.sharding.specs import (  # noqa: F401
    RowSplit,
    align_cohort_chunk,
    all_reduce_,
    barrier,
    client_axes,
    cohort_spec,
    constrain_cohort,
    mesh_backend,
    mesh_client_count,
    mesh_device,
    mesh_fingerprint,
    mesh_group,
    mesh_rank,
    ordered_index_add_,
    place_buffer_rows,
    place_cohort,
    place_replicated,
    psum_segments,
    row_split,
    segment_sum,
)

__all__ = ["RowSplit", "align_cohort_chunk", "all_reduce_", "barrier",
           "client_axes", "cohort_spec", "constrain_cohort", "mesh_backend",
           "mesh_client_count", "mesh_device", "mesh_fingerprint", "mesh_group",
           "mesh_rank", "ordered_index_add_", "place_buffer_rows", "place_cohort",
           "place_replicated", "psum_segments", "row_split", "segment_sum"]
