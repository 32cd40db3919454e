"""query_syncs_per_tick: runtime synchronisations a tick inside the
harness's range around the planner's read (``cudaDeviceSynchronize``,
``cudaStreamSynchronize``, ``cudaEventSynchronize``, synchronous
``cudaMemcpy``) in the span-trace orbit (``spans.py``); 0 where the read
never waits for the card.  One would drain the queue after every tick's
read.  Nothing where the cell does not read the map."""

from esdfbench import spans


def read(reading):
    found = spans.measure(reading)
    if found is None or found["read"] is None:
        return None
    return found["read"]["syncs"]
