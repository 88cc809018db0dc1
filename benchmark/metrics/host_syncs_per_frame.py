"""Operations that made the host wait for the card per frame of one large
frame at a time (`torch.cuda.set_sync_debug_mode('warn')`'s warnings
over the sync-counting slice), less the client's own fetch of each
result."""
from benchmark.readers import syncs_per_frame


def read(run):
    return syncs_per_frame(run)
