"""host_syncs_per_tick: runtime synchronisations a tick under the
program's ``fiesta.tick`` span (``cudaDeviceSynchronize``,
``cudaStreamSynchronize``, ``cudaEventSynchronize``, synchronous
``cudaMemcpy``) in the span-trace orbit (``spans.py``); 0 where the tick
never waits for the card.  One would drain the queue each tick and block
a CUDA graph's capture."""

from esdfbench import spans


def read(reading):
    found = spans.measure(reading)
    return None if found is None else found["tick"]["syncs"]
