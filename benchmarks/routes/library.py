"""Library mode, as ``hsip-torch --library`` runs it: one call of
``process_video_source_library`` processes every recording of the source
and writes all their tables; a recording it cannot open or write is
warned about and skipped, which the check counts as a missing answer."""

TRACKING = ("hsip_tpu_torch.track.batch", "track_collection_device")


def call(ctx, index, out_dir):
    from hsip_tpu_torch.pipeline import process_video_source_library

    ctx.source.output_dir = str(out_dir)
    process_video_source_library(ctx.source, ctx.detector, verbose=False,
                                 device=ctx.device)
    return list(range(len(ctx.paths)))


def warm(ctx, out_dir):
    call(ctx, 0, out_dir)
