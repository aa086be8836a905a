"""Scratch of the kernels that combine their blocks' partial results in the
same launch (flash-decode's split, the fused head forward's vocabulary
ranges, the BatchNorm moments' column groups): fp32 partials and int32
tickets, the last block of a group to take its ticket combining the
group's partials and setting the ticket back to 0."""
from __future__ import annotations

import torch

# (device index, stream) -> (workspace, tickets): kernels on one stream run
# in order, so one stream's launches share them, whichever kernel makes
# them; every such kernel leaves its tickets at 0, so they are zeroed once,
# when allocated, and a call launches no memset.
_WORKSPACES: dict = {}


def workspace(device, stream, n_ws: int, n_tickets: int):
    """(ws, tickets): at least ``n_ws`` fp32 and ``n_tickets`` zeroed int32
    on ``device`` for launches on ``stream``, cached and grown as needed."""
    key = (device.index, stream)
    ws, tickets = _WORKSPACES.get(key, (None, None))
    if ws is None or ws.numel() < n_ws:
        ws = torch.empty(n_ws, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    _WORKSPACES[key] = (ws, tickets)
    return ws, tickets
