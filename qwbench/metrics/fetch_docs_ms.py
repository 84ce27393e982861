"""The root's fetch (`search/root.py::_fetch_docs_phase`,
`index/reader.py::fetch_docs`): the query profile's `fetch_docs` phase,
ms per request, summed per request and averaged over the window's
completed requests."""

from qwbench.metrics._phase import mean_phase_ms


def read(run):
    return mean_phase_ms(run, "fetch_docs")
