"""Per-file processing with figures off, as ``hsip-torch --no-images
--no-sequences`` runs each recording: one call of ``process_video_file``
(backend ``device``) processes one recording, cycling through the
source."""

TRACKING = ("hsip_tpu_torch.pipeline", "track_video")


def call(ctx, index, out_dir):
    from hsip_tpu_torch.pipeline import process_video_file

    k = index % len(ctx.paths)
    ctx.source.output_dir = str(out_dir)
    process_video_file(ctx.paths[k], ctx.source, ctx.detector,
                       backend="device", verbose=False, save_images=False,
                       device=ctx.device)
    return [k]


def warm(ctx, out_dir):
    for k in range(len(ctx.paths)):
        call(ctx, k, out_dir)
