"""Bipartite maximal matching (paper §6.3, Algorithm 6).

The representative of "algorithms that send and process *different types*
of messages at different stages" (§6.4).  Typed channels model the
paper's handshake:

  req    left -> right   match request; the ``lexmin`` combiner over a
                         per-edge hash realizes the right vertex's
                         "randomly choose one request" as a deterministic
                         random-priority pick,
  grant  right -> left   targeted grant (only the edge whose destination
                         is the granted left carries a message),
  acc    left -> right   targeted acceptance,
  full   right -> left   broadcast "I am matched": lefts count exhausted
                         neighbours and retire when all are matched,
  retry  right -> left   broadcast "my grant fell through, ask again".

A combining engine keeps only the winning request, so losers are not
denied one by one: a right broadcasts ``retry``/``full`` when its grant
resolves, which re-activates them.  The fixed point is a valid maximal
matching.  No channel declares a semiring (``lexmin``, targeted emits, an
int ``sum``): every delivery takes the dense path.

Right states: 0 = ungranted, 1 = granted (waiting for acceptance, with a
countdown that ticks only at global/superstep cadence), 2 = matched.
"""

from __future__ import annotations

import torch

from repro_torch.core.vertex_program import Channel, StepInfo, VertexProgram

_IMAX = torch.iinfo(torch.int32).max
_U32 = 0xFFFFFFFF

UNGRANTED, GRANTED, MATCHED = 0, 1, 2


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c`` modulo 2**32 for int64 ``a`` in [0, 2**32): the constant
    is split into 16-bit halves so no int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _hash2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's uint32 wraparound hash, computed in int64 and
    masked to 32 bits; int32 result in [0, 2**31)."""
    x = _mul_u32(a.to(torch.int64) & _U32, 2654435761)
    y = _mul_u32(b.to(torch.int64) & _U32, 40503)
    h = _mul_u32(torch.bitwise_xor(x, y), 2246822519)
    h = torch.bitwise_xor(h, h >> 13)
    return (h & 0x7FFFFFFF).to(torch.int32)


class BipartiteMatching(VertexProgram):
    channels = (
        Channel("req", "lexmin", ((torch.int32, _IMAX), (torch.int32, _IMAX))),
        Channel("grant", "min", ((torch.int32, _IMAX),)),
        Channel("acc", "min", ((torch.int32, _IMAX),)),
        Channel("full", "sum", ((torch.int32, 0),)),
        Channel("retry", "max", ((torch.int32, 0),)),
    )
    boundary_participates = True

    def __init__(self, seed: int = 0):
        self.seed = seed

    def init(self, gid, vmask, vdata):
        is_left = vdata["is_left"]
        deg = vdata["degree"]
        state = {
            "matched": torch.full_like(gid, -1),
            "rstate": torch.zeros_like(gid),        # rights: UNGRANTED
            "grantee": torch.full_like(gid, -1),    # rights: granted left gid
            "cd": torch.zeros_like(gid),            # rights: acceptance countdown
            "n_full": torch.zeros_like(gid),        # lefts: matched neighbours
        }
        out = {
            "requesting": torch.logical_and(is_left, deg > 0),
            "grant_to": torch.full_like(gid, -1),
            "accept_to": torch.full_like(gid, -1),
            "announce_full": torch.zeros_like(vmask),
            "announce_retry": torch.zeros_like(vmask),
        }
        send = torch.logical_and(out["requesting"], vmask)  # stage 1 at init
        return state, out, send, torch.zeros_like(vmask)

    def emit(self, ch, out_src, w, src_gid, dst_gid):
        if ch.name == "req":
            pri = _hash2(src_gid + self.seed, dst_gid)
            return (pri, src_gid), out_src["requesting"]
        if ch.name == "grant":
            return (src_gid,), dst_gid == out_src["grant_to"]
        if ch.name == "acc":
            return (src_gid,), dst_gid == out_src["accept_to"]
        if ch.name == "full":
            return (torch.ones_like(src_gid),), out_src["announce_full"]
        if ch.name == "retry":
            return (torch.ones_like(src_gid),), out_src["announce_retry"]
        raise ValueError(ch.name)

    def apply(self, state, inbox, gid, vmask, vdata, info: StepInfo):
        is_left = vdata["is_left"]
        deg = vdata["degree"]
        (_, req_gid), has_req = inbox["req"]
        (grant_gid,), has_grant = inbox["grant"]
        (acc_gid,), has_acc = inbox["acc"]
        (full_cnt,), has_full = inbox["full"]
        neg = torch.logical_not

        matched = state["matched"]
        rstate = state["rstate"]
        grantee = state["grantee"]
        cd = state["cd"]
        n_full = state["n_full"] + torch.where(has_full, full_cnt, 0)

        # ---------------- left vertices (stages 1 & 3) -------------------
        l_unmatched = torch.logical_and(is_left, matched < 0)
        l_accepts = torch.logical_and(l_unmatched, has_grant)
        l_retired = torch.logical_and(l_unmatched, n_full >= deg)
        l_requesting = torch.logical_and(
            l_unmatched, torch.logical_and(neg(l_accepts), neg(l_retired)))

        # ---------------- right vertices (stages 2 & 4) ------------------
        r = neg(is_left)
        r_ungranted = torch.logical_and(r, rstate == UNGRANTED)
        r_grants = torch.logical_and(r_ungranted, has_req)
        r_granted = torch.logical_and(r, rstate == GRANTED)
        r_accepted = torch.logical_and(
            r_granted, torch.logical_and(has_acc, acc_gid == grantee))
        # the countdown ticks at global/superstep cadence only: a
        # same-partition acceptance arrives by message within two
        # pseudo-supersteps, a cross-partition one within two global
        # iterations (< the timeout)
        tick = info.phase != "local"
        r_timeout = torch.logical_and(
            r_granted, torch.logical_and(neg(r_accepted), cd <= 0)) \
            if tick else torch.zeros_like(r_granted)

        new_matched = torch.where(l_accepts, grant_gid, matched)
        new_matched = torch.where(r_accepted, acc_gid, new_matched)
        new_rstate = torch.where(r_grants, GRANTED, rstate)
        new_rstate = torch.where(r_accepted, MATCHED, new_rstate)
        new_rstate = torch.where(r_timeout, UNGRANTED, new_rstate)
        new_grantee = torch.where(r_grants, req_gid, grantee)
        new_cd = torch.where(r_grants, 3,
                             torch.clamp(cd - 1, min=0) if tick else cd)

        out = {
            "requesting": l_requesting,
            "grant_to": torch.where(r_grants, req_gid, -1),
            "accept_to": torch.where(l_accepts, grant_gid, -1),
            "announce_full": r_accepted,
            "announce_retry": r_timeout,
        }
        send = l_requesting | l_accepts | r_grants | r_accepted | r_timeout
        # granted rights must observe their own timeout even with no
        # incoming message: they stay active, for global-cadence
        # scheduling only (global_only_active keeps local phases ending)
        active = torch.logical_and(
            torch.logical_and(r, new_rstate == GRANTED), vmask)

        state = {"matched": new_matched, "rstate": new_rstate,
                 "grantee": new_grantee, "cd": new_cd, "n_full": n_full}
        return state, out, send, active

    def global_only_active(self, state, vdata):
        """Granted rights wait for remote acceptances/timeouts: they are
        scheduled at global phases, not kept spinning in local phases."""
        return torch.logical_and(torch.logical_not(vdata["is_left"]),
                                 state["rstate"] == GRANTED)
