"""Operations that made the host wait for the card per training step
(`torch.cuda.set_sync_debug_mode('warn')`'s warnings over the sync-
counting slice), less the client's own fetch of each step's loss."""
from benchmark.readers import syncs_per_frame


def read(run):
    return syncs_per_frame(run)
