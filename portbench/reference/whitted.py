"""The plain reference: a Whitted ray tracer in plain PyTorch that follows
docs/SPEC.md (castRay, Möller–Trumbore, Fresnel, Phong with shadow rays),
written apart from the program it judges and importing nothing of it.

- The search is exact and brute force in effect: triangles are grouped into
  clusters of `CLUSTER` by the Morton order of their centroids, a ray is
  tested against every triangle of every cluster whose padded bounding box
  it pierces, and the nearest hit wins (ties: sphere < plane < triangle,
  then the lower index). The box test only skips triangles a ray cannot
  hit, so the winners are those of a sweep over all triangles.
- The recursion runs as lists of live rays, one bounce at a time: each ray
  carries its pixel and its throughput, and each leaf (a miss, a diffuse
  hit, a specular hit at the last depth) adds to its pixel.
- Searches run under no_grad and return winners; the surface at the
  winner is computed again from the scene's tensors, so autograd gives the
  gradient of the shading (visibility has none, as in the program).
- `dtype` sets the precision of everything: float32 is the configuration's,
  bfloat16 the control's.
"""

import math

import numpy as np
import torch

KIND_NONE, KIND_SPHERE, KIND_PLANE, KIND_TRI = 0, 1, 2, 3
DIFFUSE, MIRROR, GLASS = 0, 1, 2
DET_EPS = 1e-8
CLUSTER = 32          # triangles per cluster
RAY_CHUNK = 1 << 16   # rays per cluster-box test
PAIR_CHUNK = 1 << 17  # (ray, cluster) pairs per triangle test
ROW_BLOCK = 1 << 19   # pixels per wavefront block
BIG = 1 << 62


def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v):
    return v / torch.sqrt(dot(v, v))[..., None]


def reflect(i, n):
    return i - 2.0 * dot(i, n)[..., None] * n


def take(table, idx):
    """table[idx]. A small table that requires grad is gathered as a sum of
    masked rows, so that its gradient is a reduction over the lanes: the
    atomic adds of an indexed gather's backward lose digits over millions
    of lanes."""
    if not table.requires_grad or table.shape[0] > 64:
        return table[idx]
    out = torch.zeros((idx.shape[0],) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    for r in range(table.shape[0]):
        out = out + (idx == r).to(table.dtype)[:, None] * table[r][None]
    return out


def morton_order(points: np.ndarray) -> np.ndarray:
    """Indices that sort `points` [n, 3] along a 10-bit-per-axis Morton
    curve."""
    lo, hi = points.min(0), points.max(0)
    q = ((points - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.int64)
    code = np.zeros(len(points), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return np.argsort(code, kind="stable")


def box_hit(o, d, bmin, bmax, t_lo, t_hi):
    """Slab test of rays o, d [..., 3] against boxes [..., 3] → bool [...]:
    the box meets the open segment (t_lo, t_hi)."""
    tiny = torch.finfo(d.dtype).tiny
    inv = 1.0 / torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
    t1, t2 = (bmin - o) * inv, (bmax - o) * inv
    near = torch.minimum(t1, t2).amax(-1)
    far = torch.maximum(t1, t2).amin(-1)
    return (near <= far) & (far > t_lo) & (near < t_hi)


def sphere_t(o, d, c, r, t_min):
    """SPEC's stable quadratic → t (inf on a miss), elementwise."""
    L = o - c
    a = dot(d, d)
    b = 2.0 * dot(d, L)
    c0 = dot(L, L) - r * r
    disc = b * b - 4.0 * a * c0
    ok = disc >= 0
    pos = disc > 0   # sqrt's slope is infinite at 0: its value, 0, is taken there
    sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, torch.ones_like(disc))), 0.0)
    q = -0.5 * (b + torch.where(b >= 0, sq, -sq))
    t0 = q / a
    qs = torch.where(q == 0, torch.ones_like(q), q)
    t1 = torch.where(q == 0, torch.full_like(q, -math.inf), c0 / qs)
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    inf = torch.full_like(lo, math.inf)
    t = torch.where(lo > t_min, lo, torch.where(hi > t_min, hi, inf))
    return torch.where(ok, t, inf)


def plane_t(o, d, p0, n, t_min):
    den = dot(n, d)
    ok = den.abs() >= DET_EPS
    t = dot(p0 - o, n) / torch.where(ok, den, torch.ones_like(den))
    return torch.where(ok & (t > t_min), t, torch.full_like(t, math.inf))


def tri_tuv(o, d, v0, e1, e2, t_min):
    """Möller–Trumbore without culling → (t, u, v); t = inf on a miss."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = det.abs() >= DET_EPS
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = o - v0
    u = dot(tvec, pvec) * inv
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv
    t = dot(e2, qvec) * inv
    ok = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > t_min)
    return torch.where(ok, t, torch.full_like(t, math.inf)), u, v


def fresnel(i, n, ior):
    cosi = dot(i, n).clamp(-1.0, 1.0)
    out = cosi > 0
    etai = torch.where(out, ior, torch.ones_like(ior))
    etat = torch.where(out, torch.ones_like(ior), ior)
    s2 = (1.0 - cosi * cosi).clamp(min=0.0)
    sint = etai / etat * torch.sqrt(torch.where(s2 > 0, s2, torch.ones_like(s2))) \
        * (s2 > 0)
    tir = sint >= 1.0
    c2 = (1.0 - sint * sint).clamp(min=0.0)
    cost = torch.sqrt(torch.where(tir, torch.ones_like(c2), c2))
    ca = cosi.abs()
    rs = (etat * ca - etai * cost) / (etat * ca + etai * cost)
    rp = (etai * ca - etat * cost) / (etai * ca + etat * cost)
    return torch.where(tir, torch.ones_like(rs), 0.5 * (rs * rs + rp * rp))


def refract(i, n, ior):
    """→ (direction, ok); ok is False on total internal reflection."""
    cosi = dot(i, n).clamp(-1.0, 1.0)
    entering = cosi < 0
    ca = cosi.abs()
    eta = torch.where(entering, 1.0 / ior, ior)
    nn = torch.where(entering[:, None], n, -n)
    k = 1.0 - eta * eta * (1.0 - ca * ca)
    ok = k >= 0
    root = torch.sqrt(torch.where(ok, k, torch.ones_like(k)))
    return eta[:, None] * i + (eta * ca - root)[:, None] * nn, ok


def offset(p, n, direc, bias):
    """p moved by bias along n, to the side `direc` leaves from (SPEC)."""
    side = torch.where(dot(direc, n) < 0, -1.0, 1.0).to(p.dtype)
    return p + (side * bias)[:, None] * n


class Reference:
    """One scene (the plain dict `scene`, see `portbench.scenes`) on one
    device in one precision. `params` may replace the sphere centers
    ("center") and the material albedos ("albedo") by tensors that require
    grad."""

    def __init__(self, scene: dict, device, dtype=torch.float32):
        self.device, self.dtype = torch.device(device), dtype
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)
        i = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
        sp, pl, me = scene["spheres"], scene["planes"], scene["mesh"]
        ma, li, op = scene["materials"], scene["lights"], scene["opts"]
        self.sph_c, self.sph_r, self.sph_m = f(sp["center"]).reshape(-1, 3), \
            f(sp["radius"]).reshape(-1), i(sp["mat"]).reshape(-1)
        self.pl = {k: f(pl[k]).reshape(-1, 3) for k in
                   ("point", "normal", "tangent", "bitangent", "albedo2")}
        self.pl_m, self.pl_chk = i(pl["mat"]).reshape(-1), i(pl["checker"]).reshape(-1)
        self.pl_s = f(pl["scale"]).reshape(-1)
        self.mtype = i(ma["mtype"])
        self.albedo = f(ma["albedo"]).reshape(-1, 3)
        self.kd, self.ks = f(ma["kd"]), f(ma["ks"])
        self.spec_n, self.ior = f(ma["spec_n"]), f(ma["ior"])
        self.l_pos, self.l_int = f(li["pos"]).reshape(-1, 3), f(li["intensity"]).reshape(-1, 3)
        self.width, self.height = int(op["width"]), int(op["height"])
        self.max_depth = int(op["max_depth"])
        self.bias, self.t_min = float(op["bias"]), float(op["t_min"])
        self.bg = f(op["background"])
        self.n_tris = 0
        if me is not None:
            self._mesh(me, f, i)

    def _mesh(self, me, f, i):
        verts = np.asarray(me["verts"], np.float32)
        tris = np.asarray(me["tris"], np.int64)
        self.n_tris = len(tris)
        self.verts, self.tris = f(verts), i(tris)
        self.vnorm = None if me["normals"] is None else f(me["normals"])
        self.tri_m = i(me["mat"]).reshape(-1)
        corners = verts[tris]                                  # [T, 3, 3]
        order = morton_order(corners.mean(1))
        k = -(-len(tris) // CLUSTER)
        ids = np.full(k * CLUSTER, -1, np.int64)
        ids[:len(order)] = order
        ids = ids.reshape(k, CLUSTER)
        c = np.where(ids[..., None, None] >= 0, corners[np.maximum(ids, 0)], 0.0)
        real = ids >= 0
        lo = np.where(real[..., None], c.min(2), np.inf).min(1)
        hi = np.where(real[..., None], c.max(2), -np.inf).max(1)
        pad = 1e-4 * float(np.linalg.norm(verts.max(0) - verts.min(0))) + 1e-6
        self.cl_ids = i(ids)
        self.cl_v0 = f(c[:, :, 0])
        self.cl_e1 = f(c[:, :, 1] - c[:, :, 0])
        self.cl_e2 = f(c[:, :, 2] - c[:, :, 0])
        self.cl_lo, self.cl_hi = f(lo - pad), f(hi + pad)
        self.box_lo, self.box_hi = f(lo.min(0) - pad), f(hi.max(0) + pad)

    # ----------------------------------------------------------- search
    def _pairs(self, o, d, t_hi):
        """(ray, cluster) index pairs whose cluster box the ray meets."""
        cand = box_hit(o, d, self.box_lo, self.box_hi, self.t_min,
                       t_hi).nonzero().squeeze(1)
        for s in range(0, cand.shape[0], RAY_CHUNK):
            rc = cand[s:s + RAY_CHUNK]
            hit = box_hit(o[rc][:, None], d[rc][:, None], self.cl_lo[None],
                          self.cl_hi[None], self.t_min, t_hi[rc][:, None])
            r, k = hit.nonzero(as_tuple=True)
            for p in range(0, r.shape[0], PAIR_CHUNK):
                yield rc[r[p:p + PAIR_CHUNK]], k[p:p + PAIR_CHUNK]

    def _tri_t(self, o, d, ray, k):
        t, _, _ = tri_tuv(o[ray][:, None], d[ray][:, None], self.cl_v0[k],
                          self.cl_e1[k], self.cl_e2[k], self.t_min)
        return t                                               # [P, CLUSTER]

    @torch.no_grad()
    def nearest(self, o, d, centers):
        """Winners of rays o, d [N, 3] among the scene with its spheres at
        `centers` → (kind [N], index [N]) int64."""
        n = o.shape[0]
        inf = torch.full((n,), math.inf, dtype=self.dtype, device=self.device)
        best, kind = inf.clone(), torch.zeros(n, dtype=torch.int64, device=self.device)
        idx = torch.zeros_like(kind)
        groups = []
        if self.sph_c.shape[0]:
            groups.append((KIND_SPHERE, sphere_t(o[:, None], d[:, None],
                                                 centers[None], self.sph_r[None],
                                                 self.t_min)))
        if self.pl_m.shape[0]:
            groups.append((KIND_PLANE, plane_t(o[:, None], d[:, None],
                                               self.pl["point"][None],
                                               self.pl["normal"][None], self.t_min)))
        for g, t in groups:
            tb, ib = t.min(1)
            better = tb < best
            best = torch.where(better, tb, best)
            kind = torch.where(better, g, kind)
            idx = torch.where(better, ib, idx)
        if self.n_tris:
            rays, ts, ids = [], [], []
            for ray, k in self._pairs(o, d, inf):
                t = self._tri_t(o, d, ray, k)
                tb, j = t.min(1)
                keep = torch.isfinite(tb)
                rays.append(ray[keep])
                ts.append(tb[keep])
                ids.append(self.cl_ids[k[keep], j[keep]])
            if rays:
                ray, t, tid = torch.cat(rays), torch.cat(ts), torch.cat(ids)
                tri_t = inf.clone().scatter_reduce(0, ray, t, "amin")
                win = t == tri_t[ray]
                tri_i = torch.full((n,), BIG, dtype=torch.int64, device=self.device)
                tri_i = tri_i.scatter_reduce(0, ray, torch.where(win, tid, BIG), "amin")
                better = tri_t < best
                kind = torch.where(better, KIND_TRI, kind)
                idx = torch.where(better, tri_i, idx)
        return kind, idx

    @torch.no_grad()
    def occluded(self, o, d, max_t, centers):
        """Any hit of rays o, d with t in (t_min, max_t), the spheres at
        `centers` → bool [N]."""
        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=self.device)
        if self.sph_c.shape[0]:
            occ |= (sphere_t(o[:, None], d[:, None], centers[None],
                             self.sph_r[None], self.t_min) < max_t[:, None]).any(1)
        if self.pl_m.shape[0]:
            occ |= (plane_t(o[:, None], d[:, None], self.pl["point"][None],
                            self.pl["normal"][None], self.t_min)
                    < max_t[:, None]).any(1)
        if self.n_tris:
            hits = torch.zeros(o.shape[0], dtype=torch.int64, device=self.device)
            for ray, k in self._pairs(o, d, max_t):
                any_hit = (self._tri_t(o, d, ray, k) < max_t[ray][:, None]).any(1)
                hits = hits.scatter_reduce(0, ray, any_hit.long(), "amax")
            occ |= hits > 0
        return occ

    # ----------------------------------------------------------- shading
    def surface(self, o, d, kind, idx, params):
        """The winners' surfaces, computed again from the scene's tensors
        → (hit [N] bool, p, n [N,3], albedo [N,3], material [N])."""
        n_rays = o.shape[0]
        z3 = o.new_zeros((n_rays, 3))
        p, nrm, alb = z3, z3, z3
        mat = torch.zeros(n_rays, dtype=torch.int64, device=self.device)
        hit = torch.zeros(n_rays, dtype=torch.bool, device=self.device)
        albedo = params.get("albedo", self.albedo)
        center = params.get("center", self.sph_c)

        def put(dst, sel, val):
            return dst.index_copy(0, sel, val)

        sel = (kind == KIND_SPHERE).nonzero().squeeze(1)
        if sel.numel():
            os_, ds, j = o[sel], d[sel], idx[sel]
            c, r = take(center, j), self.sph_r[j]
            t = sphere_t(os_, ds, c, r, self.t_min)
            ok = torch.isfinite(t)
            ps = os_ + torch.where(ok, t, 0.0)[:, None] * ds
            p, nrm = put(p, sel, ps), put(nrm, sel, (ps - c) / r[:, None])
            m = self.sph_m[j]
            mat, alb = put(mat, sel, m), put(alb, sel, take(albedo, m))
            hit = put(hit, sel, ok)
        sel = (kind == KIND_PLANE).nonzero().squeeze(1)
        if sel.numel():
            os_, ds, j = o[sel], d[sel], idx[sel]
            p0, pn = self.pl["point"][j], self.pl["normal"][j]
            t = plane_t(os_, ds, p0, pn, self.t_min)
            ok = torch.isfinite(t)
            ps = os_ + torch.where(ok, t, 0.0)[:, None] * ds
            u = dot(ps - p0, self.pl["tangent"][j])
            v = dot(ps - p0, self.pl["bitangent"][j])
            s = self.pl_s[j]
            fu, fv = u * s - torch.floor(u * s), v * s - torch.floor(v * s)
            second = ((fu > 0.5) ^ (fv > 0.5)) & (self.pl_chk[j] > 0)
            m = self.pl_m[j]
            a = torch.where(second[:, None], self.pl["albedo2"][j], take(albedo, m))
            p, nrm = put(p, sel, ps), put(nrm, sel, pn)
            mat, alb, hit = put(mat, sel, m), put(alb, sel, a), put(hit, sel, ok)
        sel = (kind == KIND_TRI).nonzero().squeeze(1)
        if sel.numel():
            os_, ds, j = o[sel], d[sel], idx[sel]
            tri = self.tris[j]
            v0 = self.verts[tri[:, 0]]
            e1, e2 = self.verts[tri[:, 1]] - v0, self.verts[tri[:, 2]] - v0
            t, u, v = tri_tuv(os_, ds, v0, e1, e2, self.t_min)
            ok = torch.isfinite(t)
            ps = os_ + torch.where(ok, t, 0.0)[:, None] * ds
            if self.vnorm is None:
                nt = normalize(cross(e1, e2))
            else:
                nt = normalize((1.0 - u - v)[:, None] * self.vnorm[tri[:, 0]]
                               + u[:, None] * self.vnorm[tri[:, 1]]
                               + v[:, None] * self.vnorm[tri[:, 2]])
            m = self.tri_m[j]
            p, nrm = put(p, sel, ps), put(nrm, sel, nt)
            mat, alb, hit = put(mat, sel, m), put(alb, sel, take(albedo, m)), put(hit, sel, ok)
        return hit, p, nrm, alb, mat

    def phong(self, p, n, d, alb, mat, centers, count):
        """Local Phong radiance with shadow rays (SPEC DIFFUSE_AND_GLOSSY)."""
        # the shadow origin: + bias·n when the ray meets the front face
        side = torch.where(dot(d, n) < 0, 1.0, -1.0).to(p.dtype)
        sorig = p + (side * self.bias)[:, None] * n
        light, spec = torch.zeros_like(p), torch.zeros_like(p)
        for li in range(self.l_pos.shape[0]):
            lvec = self.l_pos[li][None] - p
            dist = torch.sqrt(dot(lvec, lvec))
            ldir = lvec / dist[:, None]
            ldn = dot(ldir, n).clamp(min=0.0)
            lit = (ldn > 0).nonzero().squeeze(1)
            shadow = torch.zeros(p.shape[0], dtype=torch.bool, device=self.device)
            if lit.numel():
                shadow = shadow.index_copy(0, lit, self.occluded(
                    sorig[lit].detach(), ldir[lit].detach(), dist[lit].detach(),
                    centers))
            if count is not None:
                count[li] += int(lit.numel())
            vis = (~shadow).to(p.dtype)
            light = light + (vis * ldn)[:, None] * self.l_int[li][None]
            r = reflect(-ldir, n)
            spec = spec + (-dot(r, d)).clamp(min=0.0).pow(self.spec_n[mat])[:, None] \
                * self.l_int[li][None]
        return light * alb * self.kd[mat][:, None] + spec * self.ks[mat][:, None]

    def trace(self, o, d, pix, n_pix, params=None, counts=None):
        """Radiance [n_pix, 3] (unclamped) of primary rays o, d [N, 3] that
        belong to pixels `pix` [N]. `counts`, a dict, sums per bounce (over
        calls, so over a frame's blocks) the rays searched ("nearest"), the diffuse hits ("diffuse") and
        each light's shadow rays toward the lights they face ("shadow")."""
        params = params or {}
        centers = params.get("center", self.sph_c).detach()
        out = o.new_zeros((n_pix, 3))
        thr = torch.ones_like(o)
        for depth in range(self.max_depth + 1):
            if o.shape[0] == 0:
                break
            kind, idx = self.nearest(o.detach(), d.detach(), centers)
            hit, p, n, alb, mat = self.surface(o, d, kind, idx, params)
            mtype = self.mtype[mat]
            shadows = None
            if counts is not None:
                for key, zero in (("nearest", 0), ("diffuse", 0),
                                  ("shadow", [0] * self.l_pos.shape[0])):
                    seq = counts.setdefault(key, [])
                    if len(seq) <= depth:
                        seq.append(zero)
                counts["nearest"][depth] += int(o.shape[0])
                shadows = counts["shadow"][depth]
            miss = (~hit).nonzero().squeeze(1)
            out = out.index_add(0, pix[miss], thr[miss] * self.bg[None])
            dif = (hit & (mtype == DIFFUSE)).nonzero().squeeze(1)
            if counts is not None:
                counts["diffuse"][depth] += int(dif.numel())
            if dif.numel():
                local = self.phong(p[dif], n[dif], d[dif], alb[dif], mat[dif],
                                   centers, shadows)
                out = out.index_add(0, pix[dif], thr[dif] * local)
            spec = (hit & (mtype != DIFFUSE)).nonzero().squeeze(1)
            if not spec.numel():
                break
            ps, ns, ds, ts, px = p[spec], n[spec], d[spec], thr[spec], pix[spec]
            glass = mtype[spec] == GLASS
            kr = fresnel(ds, ns, self.ior[mat[spec]])
            if depth == self.max_depth:
                # children past max_depth return the background: kr·bg for a
                # mirror, kr·bg + (1 − kr)·bg for glass (kr = 1 on TIR)
                w = torch.where(glass, torch.ones_like(kr), kr)
                out = out.index_add(0, px, ts * w[:, None] * self.bg[None])
                break
            rdir = normalize(reflect(ds, ns))
            o_next, d_next = [offset(ps, ns, rdir, self.bias)], [rdir]
            thr_next, pix_next = [ts * kr[:, None]], [px]
            g = glass.nonzero().squeeze(1)
            if g.numel():
                tdir, ok = refract(ds[g], ns[g], self.ior[mat[spec]][g])
                keep = ok.nonzero().squeeze(1)
                g = g[keep]
                tdir = normalize(tdir[keep])
                o_next.append(offset(ps[g], ns[g], tdir, self.bias))
                d_next.append(tdir)
                thr_next.append(ts[g] * (1.0 - kr[g])[:, None])
                pix_next.append(px[g])
            o, d = torch.cat(o_next), torch.cat(d_next)
            thr, pix = torch.cat(thr_next), torch.cat(pix_next)
        return out

    # ----------------------------------------------------------- frames
    def primary(self, camera: dict, row0: int, rows: int):
        """Primary rays of image rows [row0, row0 + rows) (SPEC camera)."""
        w, h = self.width, self.height
        fov = torch.tensor(float(np.float32(camera["fov"])), dtype=torch.float64)
        scale = float(torch.tan(torch.deg2rad(fov) / 2.0))
        i = torch.arange(w, dtype=torch.float64)
        j = torch.arange(row0, row0 + rows, dtype=torch.float64)
        x = (2.0 * (i + 0.5) / w - 1.0) * (w / h) * scale
        y = (1.0 - 2.0 * (j + 0.5) / h) * scale
        cam = torch.stack([x[None, :].expand(rows, w), y[:, None].expand(rows, w),
                           -torch.ones(rows, w, dtype=torch.float64)], -1).reshape(-1, 3)
        cam = cam.to(device=self.device, dtype=self.dtype)
        c2w = torch.as_tensor(np.asarray(camera["c2w"], np.float32),
                              device=self.device).to(self.dtype)
        d = normalize(cam[:, 0:1] * c2w[:, 0][None] + cam[:, 1:2] * c2w[:, 1][None]
                      + cam[:, 2:3] * c2w[:, 2][None])
        o = torch.as_tensor(np.asarray(camera["pos"], np.float32),
                            device=self.device).to(self.dtype)
        return o[None].expand_as(d).contiguous(), d

    def blocks(self, height=None):
        """(row0, rows) blocks of the first `height` rows (all by default)."""
        height = self.height if height is None else height
        rows = max(1, ROW_BLOCK // self.width)
        for r0 in range(0, height, rows):
            yield r0, min(rows, height - r0)

    def image(self, camera: dict, params=None, counts=None):
        """The clamped frame [H, W, 3] in this reference's dtype."""
        out = []
        for r0, rows in self.blocks():
            o, d = self.primary(camera, r0, rows)
            n = rows * self.width
            pix = torch.arange(n, device=self.device)
            out.append(self.trace(o, d, pix, n, params, counts).clamp(0.0, 1.0))
        return torch.cat(out).reshape(self.height, self.width, 3)

    def loss_and_grad(self, camera: dict, params: dict, target, height=None):
        """Σ (frame − target)² / (H·W·3) and its gradient for each of
        `params` (tensors; fresh leaves are made here), block by block.
        `height` takes the loss over the first rows only, as a mean over
        them."""
        height = self.height if height is None else height
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        denom = float(self.width * height * 3)
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
        for r0, rows in self.blocks(height):
            o, d = self.primary(camera, r0, rows)
            n = rows * self.width
            pix = torch.arange(n, device=self.device)
            img = self.trace(o, d, pix, n, leaves).clamp(0.0, 1.0)
            tgt = target.reshape(-1, 3)[r0 * self.width:(r0 + rows) * self.width]
            loss = ((img - tgt.to(img.dtype)) ** 2).sum() / denom
            total = total + loss.detach().double()
            if not loss.requires_grad:   # rows that see nothing the leaves shade
                continue
            g = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            for k, gk in zip(leaves, g):
                if gk is not None:
                    grads[k] += gk
        return float(total), grads
