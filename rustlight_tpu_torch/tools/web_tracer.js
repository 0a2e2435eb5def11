/* In-browser progressive path tracer — the client-side compute analog of the
 * reference's WASM frontend (examples/web/src/lib.rs): `Scene::new` from a
 * scene description, `render_block(x, y, sx, sy)` accumulating one sample per
 * pixel per pass over 16x16 blocks with brute-force intersection
 * (NaiveAcceleration, accel.rs:14-77), and `get_img(ctx)` painting the
 * gamma-2.2 running average to a canvas (lib.rs:221-232).
 *
 * The transport algorithm (unidirectional path tracing with next-event
 * estimation and balance-heuristic MIS; path.rs:198-237 semantics) is written
 * here from the spec as a THIRD independent implementation: it shares no code
 * with either the JAX wavefront renderer or the scalar numpy oracle
 * (tests/oracle_pt.py) — only scene DATA arrives via /api/scene.json.
 * tests/test_viewer.py pins this file's sha256 against its line-by-line
 * Python transcription (tests/js_mirror.py) and z-tests the transcription
 * against the oracle, so edits here must update the mirror + pin.
 *
 * Scope (round 5, VERDICT r4 item 8): constant-color diffuse, Modified-Phong
 * (phong.rs:13-136), smooth-dielectric glass (glass.rs:75-124), metal
 * (smooth conductor delta + rough Beckmann/GGX microfacet, metal.rs:14-177),
 * rough FresnelBlend substrate (substrate.rs:21-225), and blends of the
 * non-glass atomics (blend.rs:9-95; exported as the renderer's own two-slot
 * design — every triangle carries slot a/b atomic parameters + blend_w).
 * Emitters: triangle area lights, point lights, directional lights, and a
 * constant environment map (emitter.rs:96-341). No medium, no textures.
 * Everything is double precision (JS numbers), deterministic via a
 * counter-based per-(pixel, pass) mulberry32 stream.
 */
'use strict';

/* eslint-disable no-bitwise */
function mulberry32(seed) {
  let a = seed >>> 0;
  return function () {
    a = (a + 0x6D2B79F5) | 0;
    let t = Math.imul(a ^ (a >>> 15), 1 | a);
    t = (t + Math.imul(t ^ (t >>> 7), 61 | t)) ^ t;
    return ((t ^ (t >>> 14)) >>> 0) / 4294967296;
  };
}

/* Distinct stream per (pixel, pass, seed): splitmix-style avalanche of the
 * packed counter so neighbouring pixels never share low-bit structure. */
function pixelRng(x, y, pass, seed) {
  let h = (x * 0x9E3779B1) ^ (y * 0x85EBCA6B) ^ (pass * 0xC2B2AE35) ^ seed;
  h = Math.imul(h ^ (h >>> 16), 0x7FEB352D);
  h = Math.imul(h ^ (h >>> 15), 0x846CA68B);
  h ^= h >>> 16;
  return mulberry32(h);
}

const EPS_ABS = 1e-4;
const EPS_REL = 2e-5;

class WebScene {
  /* desc: parsed /api/scene.json (see tools/viewer.py scene_to_web_json). */
  constructor(desc) {
    const T = desc.v0.length;
    this.n = T;
    this.v0 = desc.v0; this.e1 = desc.e1; this.e2 = desc.e2;
    this.le = desc.le;
    // two-slot material table: slot kinds 0 diffuse / 1 phong / 2 glass
    // (whole-material only) / 3 metal / 4 substrate; blend_w mixes a and b
    this.a = desc.a; this.b = desc.b;
    this.blendW = desc.blend_w;
    this.vuv = desc.vuv;                 // [T][3][2] per-corner uvs
    this.textures = desc.textures == null ? null : desc.textures;
    this.kt = desc.kt; this.eta = desc.eta;
    this.ng = new Array(T); this.area = new Array(T);
    this.isLight = new Array(T);
    this.smooth = new Array(T);
    for (let i = 0; i < T; i++) {
      const c = cross(this.e1[i], this.e2[i]);
      const l = Math.hypot(c[0], c[1], c[2]);
      this.ng[i] = l > 0 ? [c[0] / l, c[1] / l, c[2] / l] : [0, 0, 1];
      this.area[i] = 0.5 * l;
      const le = this.le[i];
      this.isLight[i] = Math.hypot(le[0], le[1], le[2]) > 0;
      // has a DELTA component -> NEE skipped (BSDFType::is_smooth)
      this.smooth[i] = this.a.kind[i] === 2 ||
        (this.a.kind[i] === 3 && this.a.alpha[i] <= 0) ||
        (this.b.kind[i] === 3 && this.b.alpha[i] <= 0);
    }
    // emitter atoms: k = 0 tri / 1 point / 2 directional / 3 constant env
    this.atoms = desc.atoms;
    this.atomProb = desc.atom_prob;
    this.points = desc.points || [];
    this.dirs = desc.dirs || [];
    this.envColor = desc.env_color == null ? null : desc.env_color;
    // textured envmap (emitter.rs:300-568): luminance*sin(theta) 2D CDF
    this.envImg = desc.env_img == null ? null : desc.env_img;
    if (this.envImg !== null) {
      const eh = this.envImg.length; const ew = this.envImg[0].length;
      this.envLum = new Array(eh);
      this.envMargCdf = new Float64Array(eh);
      this.envCondCdf = new Array(eh);
      let tot = 0;
      for (let y = 0; y < eh; y++) {
        const sw = Math.sin((y + 0.5) * Math.PI / eh);
        const row = new Float64Array(ew);
        let rs = 0;
        for (let x = 0; x < ew; x++) {
          const p = this.envImg[y][x];
          row[x] = (0.2126 * p[0] + 0.7152 * p[1] + 0.0722 * p[2]) * sw;
          rs += row[x];
        }
        this.envLum[y] = row;
        const cond = new Float64Array(ew);
        let acc = 0;
        for (let x = 0; x < ew; x++) {
          acc += row[x];
          cond[x] = rs > 0 ? acc / rs : (x + 1) / ew;
        }
        this.envCondCdf[y] = cond;
        tot += rs;
        this.envMargCdf[y] = tot;
      }
      for (let y = 0; y < eh; y++) this.envMargCdf[y] /= Math.max(tot, 1e-300);
      this.envInt = tot / (eh * ew);
    }
    this.atomCdf = new Array(this.atoms.length);
    this.envProb = 0.0;
    let acc = 0;
    for (let i = 0; i < this.atoms.length; i++) {
      acc += this.atomProb[i];
      this.atomCdf[i] = acc;
      if (this.atoms[i].k === 3) this.envProb = this.atomProb[i];
    }
    this.pdfArea = new Array(T).fill(0);
    for (let i = 0; i < this.atoms.length; i++) {
      if (this.atoms[i].k === 0) {
        const tri = this.atoms[i].ref;
        this.pdfArea[tri] = this.atomProb[i] / this.area[tri];
      }
    }
    this.s2c = desc.cam.s2c;            // [4][4] sample -> camera
    this.toWorld = desc.cam.to_world;   // [4][4]
    this.width = desc.cam.width;
    this.height = desc.cam.height;
    this.maxDepth = desc.max_depth == null ? 5 : desc.max_depth;
    this.minDepth = desc.min_depth == null ? 0 : desc.min_depth;
    this.seed = desc.seed == null ? 0 : desc.seed;

    // running average film, lib.rs:42-44 (img + nb_samples), plus a
    // sum-of-squares channel so the agreement artifact can carry the
    // variance of the mean for its z-test
    this.img = new Float64Array(this.width * this.height * 3);
    this.img2 = new Float64Array(this.width * this.height * 3);
    this.nbSamples = new Uint32Array(this.width * this.height);
  }

  cameraRay(px, py) {
    // sample-space point -> camera space -> world (camera.rs:81-91)
    const s = [px / this.width, py / this.height, 0.0, 1.0];
    const q = [0, 0, 0, 0];
    for (let r = 0; r < 4; r++) {
      q[r] = this.s2c[r][0] * s[0] + this.s2c[r][1] * s[1] +
             this.s2c[r][2] * s[2] + this.s2c[r][3] * s[3];
    }
    let d = [q[0] / q[3], q[1] / q[3], q[2] / q[3]];
    d = norm(d);
    const m = this.toWorld;
    const dw = [
      m[0][0] * d[0] + m[0][1] * d[1] + m[0][2] * d[2],
      m[1][0] * d[0] + m[1][1] * d[1] + m[1][2] * d[2],
      m[2][0] * d[0] + m[2][1] * d[1] + m[2][2] * d[2],
    ];
    return [[m[0][3], m[1][3], m[2][3]], dw];
  }

  /* Closest hit, Moller-Trumbore over every triangle (NaiveAcceleration). */
  intersect(o, d, tmax) {
    let best = -1; let bestT = tmax; let bu = 0; let bv = 0;
    for (let i = 0; i < this.n; i++) {
      const e1 = this.e1[i]; const e2 = this.e2[i]; const v0 = this.v0[i];
      const px = d[1] * e2[2] - d[2] * e2[1];
      const py = d[2] * e2[0] - d[0] * e2[2];
      const pz = d[0] * e2[1] - d[1] * e2[0];
      const det = e1[0] * px + e1[1] * py + e1[2] * pz;
      if (Math.abs(det) < 1e-12) continue;
      const inv = 1.0 / det;
      const tx = o[0] - v0[0]; const ty = o[1] - v0[1]; const tz = o[2] - v0[2];
      const u = (tx * px + ty * py + tz * pz) * inv;
      if (u < 0 || u > 1) continue;
      const qx = ty * e1[2] - tz * e1[1];
      const qy = tz * e1[0] - tx * e1[2];
      const qz = tx * e1[1] - ty * e1[0];
      const v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv;
      if (v < 0 || u + v > 1) continue;
      const t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv;
      if (t > EPS_ABS && t < bestT) { bestT = t; best = i; bu = u; bv = v; }
    }
    return [best, bestT, bu, bv];
  }

  uvAt(tri, b1, b2) {
    if (this.vuv == null) return [0, 0];   // untextured export ships no uvs
    const w = this.vuv[tri];
    const w0 = 1.0 - b1 - b2;
    return [w0 * w[0][0] + b1 * w[1][0] + b2 * w[2][0],
            w0 * w[0][1] + b1 * w[1][1] + b2 * w[2][1]];
  }

  /* Diffuse-slot color at uv (BSDFColor, mod.rs:11-121): constant /
   * bitmap / checkerboard (Rust as-i32 truncation + C-style signed %,
   * which JS % matches) / grid. */
  albedo(sl, tri, uv) {
    const tk = sl.tex_kind[tri];
    if (tk === 0) return sl.kd[tri];
    const sc = sl.tex_scale[tri]; const of = sl.tex_offset[tri];
    const su = [uv[0] * sc[0] + of[0], uv[1] * sc[1] + of[1]];
    if (tk === 2) {                      // checkerboard
      const x = 2 * (Math.trunc(su[0] * 2.0) % 2) - 1;
      const y = 2 * (Math.trunc(su[1] * 2.0) % 2) - 1;
      return x * y === 1 ? sl.kd[tri] : sl.tex_c1[tri];
    }
    if (tk === 3) {                      // grid
      let gx = su[0] - Math.floor(su[0]);
      let gy = su[1] - Math.floor(su[1]);
      if (gx > 0.5) gx -= 1.0;
      if (gy > 0.5) gy -= 1.0;
      const lw = sl.tex_lw[tri];
      return (Math.abs(gx) < lw || Math.abs(gy) < lw)
        ? sl.kd[tri] : sl.tex_c1[tri];
    }
    // bitmap: repeat wrap, v up (pixel_uv, structure.rs:434-453)
    const img = this.textures[sl.tex_img[tri]];
    const th = img.length; const tw = img[0].length;
    const fu = uv[0] - Math.floor(uv[0]);
    const fv = uv[1] - Math.floor(uv[1]);
    const xi = Math.min(Math.trunc(fu * tw), tw - 1);
    const yi = Math.min(Math.trunc((1.0 - fv) * th), th - 1);
    return img[yi][xi];
  }

  occluded(p0, p1) {
    const dx = p1[0] - p0[0]; const dy = p1[1] - p0[1]; const dz = p1[2] - p0[2];
    const dist = Math.hypot(dx, dy, dz);
    if (dist <= 0) return true;
    const d = [dx / dist, dy / dist, dz / dist];
    const [tri] = this.intersect(p0, d, dist * (1.0 - 1e-4));
    return tri >= 0;
  }

  /* Any hit along an (infinite) ray — env / directional visibility. */
  occludedRay(p0, d) {
    const [tri] = this.intersect(p0, d, Infinity);
    return tri >= 0;
  }

  offset(p, n, d) {
    const eps = EPS_ABS + EPS_REL *
      Math.max(Math.abs(p[0]), Math.abs(p[1]), Math.abs(p[2]));
    const s = dot(n, d) >= 0 ? 1.0 : -1.0;
    return [p[0] + n[0] * eps * s, p[1] + n[1] * eps * s,
            p[2] + n[2] * eps * s];
  }

  /* One NEE sample from p_ref: atom selection by flux CDF, then per-kind
   * sampling (emitter.rs:96-341, 652-688). Delta atoms (point/directional)
   * return isDelta=true: NEE is their only strategy, MIS weight 1. */
  sampleLight(pRef, rng) {
    const u = rng();
    let i = 0;
    while (i < this.atomCdf.length - 1 && u > this.atomCdf[i]) i++;
    const at = this.atoms[i]; const prob = this.atomProb[i];
    if (at.k === 0) {
      const tri = at.ref;
      const su = Math.sqrt(rng());
      const b1 = 1.0 - su; const b2 = rng() * su;
      const v0 = this.v0[tri]; const e1 = this.e1[tri]; const e2 = this.e2[tri];
      const pL = [v0[0] + b1 * e1[0] + b2 * e2[0],
                  v0[1] + b1 * e1[1] + b2 * e2[1],
                  v0[2] + b1 * e1[2] + b2 * e2[2]];
      const del = [pL[0] - pRef[0], pL[1] - pRef[1], pL[2] - pRef[2]];
      const dist = Math.hypot(del[0], del[1], del[2]);
      if (dist <= 0) return null;
      const d = [del[0] / dist, del[1] / dist, del[2] / dist];
      const cosL = -dot(this.ng[tri], d);
      if (cosL <= 0) return null;
      const g = cosL / (dist * dist);
      const pdfA = this.pdfArea[tri];
      const le = this.le[tri];
      return {
        d, dist, pL, isDelta: false,
        weight: [le[0] * g / pdfA, le[1] * g / pdfA, le[2] * g / pdfA],
        pdfSa: pdfA * dist * dist / cosL,
      };
    }
    if (at.k === 1) {                     // point light: I / d^2
      const [pos, inten] = this.points[at.ref];
      const del = [pos[0] - pRef[0], pos[1] - pRef[1], pos[2] - pRef[2]];
      const dist = Math.hypot(del[0], del[1], del[2]);
      if (dist <= 0) return null;
      const d = [del[0] / dist, del[1] / dist, del[2] / dist];
      const s = 1.0 / (dist * dist * prob);
      return { d, dist, pL: pos, isDelta: true, pdfSa: 0.0,
               weight: [inten[0] * s, inten[1] * s, inten[2] * s] };
    }
    if (at.k === 2) {                     // directional: I, ray to infinity
      const [dn, inten] = this.dirs[at.ref];
      return { d: [-dn[0], -dn[1], -dn[2]], dist: null, pL: null,
               isDelta: true, pdfSa: 0.0,
               weight: [inten[0] / prob, inten[1] / prob,
                        inten[2] / prob] };
    }
    if (this.envImg === null) {
      // constant env: uniform sphere, pdf = prob / 4pi
      const z = 1.0 - 2.0 * rng();
      const r = Math.sqrt(Math.max(1.0 - z * z, 0.0));
      const phi = 2.0 * Math.PI * rng();
      const d = [r * Math.cos(phi), r * Math.sin(phi), z];
      const pdfSa = prob / (4.0 * Math.PI);
      const e = this.envColor;
      return { d, dist: null, pL: null, isDelta: false, pdfSa,
               weight: [e[0] / pdfSa, e[1] / pdfSa, e[2] / pdfSa] };
    }
    // textured env: marginal row CDF then in-row conditional, texel jitter
    const eh = this.envImg.length; const ew = this.envImg[0].length;
    const uy = rng();
    let yi = 0;
    while (yi < eh - 1 && uy > this.envMargCdf[yi]) yi++;
    const ux = rng();
    let xi = 0;
    while (xi < ew - 1 && ux > this.envCondCdf[yi][xi]) xi++;
    const x = xi + rng();
    const y = yi + rng();
    const phi = 2.0 * Math.PI * x / ew;
    const theta = Math.PI * y / eh;
    const st = Math.sin(theta); const ct = Math.cos(theta);
    if (st <= 0) return null;
    const d = [st * Math.cos(phi), st * Math.sin(phi), ct];
    const cell = this.envLum[yi][xi] / Math.max(this.envInt, 1e-300);
    const pdfSa = prob * cell / (2.0 * Math.PI * Math.PI * st);
    if (pdfSa <= 0) return null;
    const e = this.envImg[yi][xi];
    return { d, dist: null, pL: null, isDelta: false, pdfSa,
             weight: [e[0] / pdfSa, e[1] / pdfSa, e[2] / pdfSa] };
  }

  lightPdfSa(tri, pRef, pHit, d) {
    const cosL = -dot(this.ng[tri], d);
    if (cosL <= 0 || !this.isLight[tri]) return 0.0;
    const dx = pHit[0] - pRef[0]; const dy = pHit[1] - pRef[1];
    const dz = pHit[2] - pRef[2];
    return this.pdfArea[tri] * (dx * dx + dy * dy + dz * dz) / cosL;
  }

  envRadiance(d) {
    if (this.envImg === null) return this.envColor;
    const theta = Math.acos(Math.max(-1, Math.min(1, d[2])));
    let phi = Math.atan2(d[1], d[0]);
    if (phi < 0) phi += 2.0 * Math.PI;
    const eh = this.envImg.length; const ew = this.envImg[0].length;
    const xi = Math.min(Math.trunc(phi / (2.0 * Math.PI) * ew), ew - 1);
    const yi = Math.min(Math.trunc(theta / Math.PI * eh), eh - 1);
    return this.envImg[yi][xi];
  }

  envPdfSa(d) {
    if (this.envImg === null) return this.envProb / (4.0 * Math.PI);
    const theta = Math.acos(Math.max(-1, Math.min(1, d[2])));
    let phi = Math.atan2(d[1], d[0]);
    if (phi < 0) phi += 2.0 * Math.PI;
    const eh = this.envImg.length; const ew = this.envImg[0].length;
    const xi = Math.min(Math.trunc(phi / (2.0 * Math.PI) * ew), ew - 1);
    const yi = Math.min(Math.trunc(theta / Math.PI * eh), eh - 1);
    const cell = this.envLum[yi][xi] / Math.max(this.envInt, 1e-300);
    const st = Math.sin(theta);
    if (st <= 0) return 0.0;
    return this.envProb * cell / (2.0 * Math.PI * Math.PI * st);
  }

  onb(n) {
    // ONB about n: Gram-Schmidt off the smallest component
    const a = [0, 0, 0];
    const ax = Math.abs(n[0]); const ay = Math.abs(n[1]); const az = Math.abs(n[2]);
    a[ax <= ay ? (ax <= az ? 0 : 2) : (ay <= az ? 1 : 2)] = 1.0;
    const t = norm(cross(n, a));
    return [t, cross(n, t)];
  }

  cosineHemisphereUv(n, u1, u2) {
    const r = Math.sqrt(u1);
    const phi = 2.0 * Math.PI * u2;
    const x = r * Math.cos(phi); const y = r * Math.sin(phi);
    const z = Math.sqrt(Math.max(1.0 - u1, 0.0));
    const [t, b] = this.onb(n);
    return [[x * t[0] + y * b[0] + z * n[0],
             x * t[1] + y * b[1] + z * n[1],
             x * t[2] + y * b[2] + z * n[2]], z / Math.PI];
  }

  cosineHemisphere(n, rng) {
    return this.cosineHemisphereUv(n, rng(), rng());
  }

  /* ---------------- microfacet + fresnel helpers (local frame) -------- */

  /* Unpolarized conductor Fresnel per channel — the standard 2a|cos| form
   * (the reference's utils.rs:88 multiplies a by 2cos^2, treated as the
   * typo the renderer also does not reproduce). */
  fresnelConductor(ct, eta3, k3) {
    const out = [0, 0, 0];
    const ct2 = ct * ct;
    const st2 = 1.0 - ct2;
    const st4 = st2 * st2;
    for (let c = 0; c < 3; c++) {
      const eta = eta3[c]; const k = k3[c];
      const t1 = eta * eta - k * k - st2;
      const a2pb2 = Math.sqrt(Math.max(t1 * t1 + 4.0 * k * k * eta * eta, 0));
      const a = Math.sqrt(Math.max(0.5 * (a2pb2 + t1), 0));
      const term1 = a2pb2 + ct2;
      const term2 = 2.0 * a * Math.abs(ct);
      const rs2 = (term1 - term2) / (term1 + term2);
      const term3 = a2pb2 * ct2 + st4;
      const term4 = term2 * st2;
      out[c] = 0.5 * (rs2 + rs2 * (term3 - term4) / (term3 + term4));
    }
    return out;
  }

  schlick(rs, ct) {
    const p = Math.pow(1.0 - ct, 5);
    return [rs[0] + (1.0 - rs[0]) * p, rs[1] + (1.0 - rs[1]) * p,
            rs[2] + (1.0 - rs[2]) * p];
  }

  /* Isotropic Beckmann/GGX NDF D(m) (distribution.rs:26-55). */
  mfEval(ggx, alpha, m) {
    const ct = m[2];
    if (ct <= 0) return 0.0;
    const ct2 = ct * ct;
    const bexp = (m[0] * m[0] + m[1] * m[1]) / (alpha * alpha) / ct2;
    let res;
    if (ggx) {
      const root = (1.0 + bexp) * ct2;
      res = 1.0 / (Math.PI * alpha * alpha * root * root);
    } else {
      res = Math.exp(-bexp) / (Math.PI * alpha * alpha * ct2 * ct2);
    }
    return res * ct < 1e-20 ? 0.0 : res;
  }

  /* Sample a half-vector from D(m) cos(m); [m, pdf]
   * (distribution.rs:62-107). */
  mfSample(ggx, alpha, u1, u2) {
    const sp = Math.sin(2.0 * Math.PI * u2);
    const cp = Math.cos(2.0 * Math.PI * u2);
    const a2 = alpha * alpha;
    let ct; let pdf;
    if (ggx) {
      const t2 = a2 * u1 / Math.max(1.0 - u1, 1e-12);
      ct = 1.0 / Math.sqrt(1.0 + t2);
      const tmp = 1.0 + t2 / a2;
      pdf = (1.0 / Math.PI) / (a2 * ct * ct * ct * tmp * tmp);
    } else {
      const t2 = a2 * -Math.log(Math.max(1.0 - u1, 1e-12));
      ct = 1.0 / Math.sqrt(1.0 + t2);
      pdf = (1.0 - u1) / (Math.PI * a2 * ct * ct * ct);
    }
    if (pdf < 1e-20) pdf = 0.0;
    const st = Math.sqrt(Math.max(1.0 - ct * ct, 0.0));
    return [[st * cp, st * sp, ct], pdf];
  }

  mfG1(ggx, alpha, v, m) {
    if (dot(v, m) * v[2] <= 0) return 0.0;
    const ct = Math.abs(v[2]);
    const st = Math.sqrt(Math.max(1.0 - ct * ct, 0.0));
    if (st === 0) return 1.0;
    const tanT = st / Math.max(ct, 1e-12);
    if (ggx) {
      const root = alpha * tanT;
      return 2.0 / (1.0 + Math.sqrt(1.0 + root * root));
    }
    const a = 1.0 / (alpha * tanT);
    if (a >= 1.6) return 1.0;
    const a2 = a * a;
    return (3.535 * a + 2.181 * a2) / (1.0 + 2.276 * a + 2.577 * a2);
  }

  mfG(ggx, alpha, wi, wo, m) {
    return this.mfG1(ggx, alpha, wi, m) * this.mfG1(ggx, alpha, wo, m);
  }

  /* ---------------- two-slot BSDF layer ------------------------------- */

  /* (f including the outgoing cosine, solid-angle pdf) for ONE atomic slot
   * in world directions; delta archetypes (glass slot, smooth metal)
   * evaluate to zero here. phong.rs:66-121, metal.rs:110-155,
   * substrate.rs:150-205. */
  atomicEvalPdf(sl, tri, n, dInRay, dOut, uv) {
    const cosO = dot(n, dOut);
    const wiW = [-dInRay[0], -dInRay[1], -dInRay[2]];
    const cosI = dot(n, wiW);
    if (cosO <= 0 || cosI <= 0) return [[0, 0, 0], 0.0];
    const kind = sl.kind[tri];
    const kd = this.albedo(sl, tri, uv);
    if (kind === 0) {
      return [[kd[0] / Math.PI * cosO, kd[1] / Math.PI * cosO,
               kd[2] / Math.PI * cosO], cosO / Math.PI];
    }
    if (kind === 1) {
      const nwi = 2.0 * dot(n, wiW);
      const refl = [nwi * n[0] - wiW[0], nwi * n[1] - wiW[1],
                    nwi * n[2] - wiW[2]];
      const alpha = dot(refl, dOut);
      const e = sl.exponent[tri]; const ws = sl.wspec[tri];
      const ksv = sl.ks[tri];
      let specScale = 0.0; let pdfS = 0.0;
      if (alpha > 0) {
        const ae = Math.pow(alpha, e);
        specScale = ae * (e + 2.0) / (2.0 * Math.PI);
        pdfS = ws * ae * (e + 1.0) / (2.0 * Math.PI);
      }
      const f = [ksv[0] * specScale + kd[0] * cosO / Math.PI,
                 ksv[1] * specScale + kd[1] * cosO / Math.PI,
                 ksv[2] * specScale + kd[2] * cosO / Math.PI];
      return [f, pdfS + (1.0 - ws) * cosO / Math.PI];
    }
    if (kind === 3 || kind === 4) {
      const [t, b] = this.onb(n);
      const wi = [dot(wiW, t), dot(wiW, b), cosI];
      const wo = [dot(dOut, t), dot(dOut, b), cosO];
      if (kind === 3) {
        const alpha = sl.alpha[tri];
        if (alpha <= 0) return [[0, 0, 0], 0.0];   // delta
        const h = [wi[0] + wo[0], wi[1] + wo[1], wi[2] + wo[2]];
        const hl = Math.hypot(h[0], h[1], h[2]);
        if (hl <= 1e-20) return [[0, 0, 0], 0.0];
        h[0] /= hl; h[1] /= hl; h[2] /= hl;
        const D = this.mfEval(sl.ggx[tri], alpha, h);
        if (D === 0) return [[0, 0, 0], 0.0];
        const F = this.fresnelConductor(dot(wi, h), sl.eta_c[tri],
                                        sl.k_c[tri]);
        const G = this.mfG(sl.ggx[tri], alpha, wi, wo, h);
        const ksv = sl.ks[tri];
        const scale = D * G / (4.0 * wi[2]);
        const f = [ksv[0] * F[0] * scale, ksv[1] * F[1] * scale,
                   ksv[2] * F[2] * scale];
        return [f, D * h[2] / (4.0 * Math.abs(dot(wo, h)))];
      }
      // substrate
      const alpha = sl.alpha[tri];
      const ksv = sl.ks[tri];
      const h = [wi[0] + wo[0], wi[1] + wo[1], wi[2] + wo[2]];
      const hl = Math.hypot(h[0], h[1], h[2]);
      const dscale = (28.0 / (23.0 * Math.PI)) *
        (1.0 - Math.pow(1.0 - 0.5 * Math.abs(wi[2]), 5)) *
        (1.0 - Math.pow(1.0 - 0.5 * Math.abs(wo[2]), 5));
      const diff = [kd[0] * (1.0 - ksv[0]) * dscale,
                    kd[1] * (1.0 - ksv[1]) * dscale,
                    kd[2] * (1.0 - ksv[2]) * dscale];
      let spec = [0, 0, 0]; let pdfSpec = 0.0;
      if (hl > 1e-20) {
        h[0] /= hl; h[1] /= hl; h[2] /= hl;
        const D = this.mfEval(sl.ggx[tri], alpha, h);
        const denom = 4.0 * Math.abs(dot(wi, h)) *
          Math.max(Math.abs(wi[2]), Math.abs(wo[2]));
        if (D > 0 && denom > 0) {
          const sf = this.schlick(ksv, dot(wi, h));
          spec = [sf[0] * D / denom, sf[1] * D / denom, sf[2] * D / denom];
          pdfSpec = D * h[2] / (4.0 * Math.abs(dot(wo, h)));
        }
      }
      const f = [(diff[0] + spec[0]) * wo[2], (diff[1] + spec[1]) * wo[2],
                 (diff[2] + spec[2]) * wo[2]];
      return [f, 0.5 * (wo[2] / Math.PI + pdfSpec)];
    }
    return [[0, 0, 0], 0.0];              // glass slot: delta-only
  }

  /* (f, pdf) resolving the two-slot mixture (blend.rs:9-95). */
  bsdfEvalPdf(tri, n, dInRay, dOut, uv) {
    const w = this.blendW[tri];
    const [fa, pa] = this.atomicEvalPdf(this.a, tri, n, dInRay, dOut, uv);
    if (w >= 1.0) return [fa, pa];
    const [fb, pb] = this.atomicEvalPdf(this.b, tri, n, dInRay, dOut, uv);
    return [[w * fa[0] + (1 - w) * fb[0], w * fa[1] + (1 - w) * fb[1],
             w * fa[2] + (1 - w) * fb[2]], w * pa + (1 - w) * pb];
  }

  /* [d, pdf, weight, isDelta] or null for one atomic slot. */
  atomicSample(sl, tri, n, dInRay, rng, uv) {
    const kind = sl.kind[tri];
    if (kind === 0) {
      const [dNew, pdf] = this.cosineHemisphere(n, rng);
      if (pdf <= 0) return null;
      return [dNew, pdf, this.albedo(sl, tri, uv).slice(), false];
    }
    if (kind === 1) {
      const e = sl.exponent[tri]; const ws = sl.wspec[tri];
      let u = rng(); const v = rng();
      let dNew;
      if (u < ws) {
        u = u / ws;
        const wi = [-dInRay[0], -dInRay[1], -dInRay[2]];
        const nwi = 2.0 * dot(n, wi);
        const refl = [nwi * n[0] - wi[0], nwi * n[1] - wi[1],
                      nwi * n[2] - wi[2]];
        const cosA = Math.pow(v, 1.0 / (e + 1.0));
        const sinA = Math.sqrt(Math.max(1.0 - cosA * cosA, 0.0));
        const phi = 2.0 * Math.PI * u;
        const [t, b] = this.onb(refl);
        const x = sinA * Math.cos(phi); const y = sinA * Math.sin(phi);
        dNew = [x * t[0] + y * b[0] + cosA * refl[0],
                x * t[1] + y * b[1] + cosA * refl[1],
                x * t[2] + y * b[2] + cosA * refl[2]];
        if (dot(n, dNew) <= 0) return null;   // under the surface: kill
      } else {
        u = (u - ws) / (1.0 - ws);
        [dNew] = this.cosineHemisphereUv(n, u, v);
      }
      const [f, pdf] = this.atomicEvalPdf(sl, tri, n, dInRay, dNew, uv);
      if (pdf <= 0) return null;
      return [dNew, pdf, [f[0] / pdf, f[1] / pdf, f[2] / pdf], false];
    }
    if (kind === 3) {
      const [t, b] = this.onb(n);
      const wiW = [-dInRay[0], -dInRay[1], -dInRay[2]];
      const wi = [dot(wiW, t), dot(wiW, b), dot(wiW, n)];
      if (wi[2] <= 0) return null;
      const alpha = sl.alpha[tri];
      if (alpha <= 0) {
        // smooth conductor: delta mirror (metal.rs:26-37)
        const wo = [-wi[0], -wi[1], wi[2]];
        const F = this.fresnelConductor(wi[2], sl.eta_c[tri], sl.k_c[tri]);
        const ksv = sl.ks[tri];
        const w = [ksv[0] * F[0], ksv[1] * F[1], ksv[2] * F[2]];
        const dW = [wo[0] * t[0] + wo[1] * b[0] + wo[2] * n[0],
                    wo[0] * t[1] + wo[1] * b[1] + wo[2] * n[1],
                    wo[0] * t[2] + wo[1] * b[2] + wo[2] * n[2]];
        return [dW, 1.0, w, true];
      }
      const [h, pdfM] = this.mfSample(sl.ggx[tri], alpha, rng(), rng());
      if (pdfM <= 0) return null;
      const wih = dot(wi, h);
      const wo = [2.0 * wih * h[0] - wi[0], 2.0 * wih * h[1] - wi[1],
                  2.0 * wih * h[2] - wi[2]];
      if (wo[2] <= 0) return null;
      const D = this.mfEval(sl.ggx[tri], alpha, h);
      const G = this.mfG(sl.ggx[tri], alpha, wi, wo, h);
      const F = this.fresnelConductor(wih, sl.eta_c[tri], sl.k_c[tri]);
      const ksv = sl.ks[tri];
      const scale = D * G * wih / (pdfM * wi[2]);
      const w = [ksv[0] * F[0] * scale, ksv[1] * F[1] * scale,
                 ksv[2] * F[2] * scale];
      const pdf = pdfM / (4.0 * Math.abs(dot(wo, h)));
      const dW = [wo[0] * t[0] + wo[1] * b[0] + wo[2] * n[0],
                  wo[0] * t[1] + wo[1] * b[1] + wo[2] * n[1],
                  wo[0] * t[2] + wo[1] * b[2] + wo[2] * n[2]];
      return [dW, pdf, w, false];
    }
    if (kind === 4) {
      // 0.5/0.5 lobe select with random reuse (substrate.rs:33-72)
      const [t, b] = this.onb(n);
      const wiW = [-dInRay[0], -dInRay[1], -dInRay[2]];
      const wi = [dot(wiW, t), dot(wiW, b), dot(wiW, n)];
      if (wi[2] <= 0) return null;
      const sx = rng();
      let dNew;
      if (sx < 0.5) {
        [dNew] = this.cosineHemisphereUv(n, sx * 2.0, rng());
      } else {
        const [h, pdfM] = this.mfSample(sl.ggx[tri], sl.alpha[tri],
                                        (sx - 0.5) * 2.0, rng());
        if (pdfM <= 0) return null;
        const wih = dot(wi, h);
        const wo = [2.0 * wih * h[0] - wi[0], 2.0 * wih * h[1] - wi[1],
                    2.0 * wih * h[2] - wi[2]];
        if (wo[2] <= 0) return null;
        dNew = [wo[0] * t[0] + wo[1] * b[0] + wo[2] * n[0],
                wo[0] * t[1] + wo[1] * b[1] + wo[2] * n[1],
                wo[0] * t[2] + wo[1] * b[2] + wo[2] * n[2]];
      }
      const [f, pdf] = this.atomicEvalPdf(sl, tri, n, dInRay, dNew, uv);
      if (pdf <= 0) return null;
      return [dNew, pdf, [f[0] / pdf, f[1] / pdf, f[2] / pdf], false];
    }
    return null;
  }

  /* [d, pdf, weight, isDelta] or null, resolving blends: lobe select by
   * blend_w with random reuse skipped (fresh draw), mixture pdf/weight
   * recombined for non-delta samples (blend.rs:9-95). */
  bsdfSample(tri, n, dInRay, rng, uv) {
    const w = this.blendW[tri];
    if (w >= 1.0) return this.atomicSample(this.a, tri, n, dInRay, rng, uv);
    const u = rng();
    const sl = u < w ? this.a : this.b;
    const res = this.atomicSample(sl, tri, n, dInRay, rng, uv);
    if (res === null) return null;
    const [dNew, , , isDelta] = res;
    if (isDelta) return res;
    const [fMix, pdfMix] = this.bsdfEvalPdf(tri, n, dInRay, dNew, uv);
    if (pdfMix <= 0) return null;
    return [dNew, pdfMix,
            [fMix[0] / pdfMix, fMix[1] / pdfMix, fMix[2] / pdfMix], false];
  }

  /* (unpolarized reflectance, signed cos_theta_t); utils.rs:99-130. */
  fresnelDielectric(cosI, eta) {
    if (eta === 1.0) return [0.0, -cosI];
    const scale = cosI > 0 ? 1.0 / eta : eta;
    const cosT2 = 1.0 - (1.0 - cosI * cosI) * (scale * scale);
    if (cosT2 <= 0) return [1.0, 0.0];          // total internal reflection
    const ci = Math.abs(cosI);
    let ct = Math.sqrt(cosT2);
    const rs = (ci - eta * ct) / (ci + eta * ct);
    const rp = (eta * ci - ct) / (eta * ci + ct);
    if (cosI > 0) ct = -ct;
    return [0.5 * (rs * rs + rp * rp), ct];
  }

  /* Smooth-dielectric delta interface (glass.rs:75-124): Fresnel-selected
   * reflect/refract in the UNFLIPPED geometric frame, radiance eta^2
   * scaling on transmission. Returns [dWorld, weight]. */
  glassSample(tri, ng, dInRay, rng) {
    const [t, b] = this.onb(ng);
    const wi = [-dot(dInRay, t), -dot(dInRay, b), -dot(dInRay, ng)];
    const eta = this.eta[tri];
    const invEta = 1.0 / eta;
    const [fresnel, cosT] = this.fresnelDielectric(wi[2], eta);
    let wo; let weight;
    if (rng() <= fresnel) {
      wo = [-wi[0], -wi[1], wi[2]];
      weight = this.a.ks[tri].slice();
    } else {
      const scale = cosT < 0 ? -invEta : -eta;
      wo = [scale * wi[0], scale * wi[1], cosT];
      const factor = cosT < 0 ? invEta : eta;
      const ktv = this.kt[tri];
      weight = [ktv[0] * factor * factor, ktv[1] * factor * factor,
                ktv[2] * factor * factor];
    }
    return [[wo[0] * t[0] + wo[1] * b[0] + wo[2] * ng[0],
             wo[0] * t[1] + wo[1] * b[1] + wo[2] * ng[1],
             wo[0] * t[2] + wo[1] * b[2] + wo[2] * ng[2]], weight];
  }

  /* Recursive radiance along (o, d) with k edges completed. prevNee =
   * NEE was actually POSSIBLE at the previous vertex (path.py's
   * nee_possible): at a smooth vertex NEE is skipped, so a non-delta
   * continuation's emitter/env hit gets weight 1 — no balance against a
   * strategy that never ran. */
  radiance(o, d, rng, k, prevPdf, prevDelta, prevNee) {
    const [tri, tHit, bu, bv] = this.intersect(o, d, Infinity);
    const L = [0, 0, 0];
    if (tri < 0) {
      // escaped: environment emission through the k+1-edge path
      if ((this.envColor !== null || this.envImg !== null)
          && k >= this.minDepth) {
        const w = (prevDelta || !prevNee) ? 1.0
          : balance(prevPdf, this.envPdfSa(d));
        const e = this.envRadiance(d);
        L[0] += e[0] * w; L[1] += e[1] * w; L[2] += e[2] * w;
      }
      return L;
    }
    const pHit = [o[0] + d[0] * tHit, o[1] + d[1] * tHit,
                  o[2] + d[2] * tHit];
    const ng = this.ng[tri];
    if (this.isLight[tri] && k >= this.minDepth && -dot(ng, d) > 0) {
      const w = (prevDelta || !prevNee) ? 1.0
        : balance(prevPdf, this.lightPdfSa(tri, o, pHit, d));
      const le = this.le[tri];
      L[0] += le[0] * w; L[1] += le[1] * w; L[2] += le[2] * w;
    }
    const canExpand = this.maxDepth == null || k + 1 < this.maxDepth;
    if (!canExpand) return L;

    // glass keeps the UNFLIPPED geometric frame (wi.z sign = inside/out)
    const uv = this.uvAt(tri, bu, bv);
    const isGlass = this.a.kind[tri] === 2;
    const smooth = this.smooth[tri];
    let n = ng;
    if (!isGlass && !this.isLight[tri] && dot(n, d) > 0) {
      n = [-n[0], -n[1], -n[2]];
    }

    // NEE, path of k+2 edges; skipped at smooth (delta-lobed) materials
    if (k + 1 >= this.minDepth && !smooth) {
      const ls = this.sampleLight(pHit, rng);
      if (ls !== null) {
        const [f, pdfOther] = this.bsdfEvalPdf(tri, n, d, ls.d, uv);
        if (Math.max(f[0], f[1], f[2]) > 0) {
          const pShadow = this.offset(pHit, ng, ls.d);
          const vis = ls.dist === null ? !this.occludedRay(pShadow, ls.d)
            : !this.occluded(pShadow, ls.pL);
          if (vis) {
            const w = ls.isDelta ? 1.0 : balance(ls.pdfSa, pdfOther);
            L[0] += f[0] * ls.weight[0] * w;
            L[1] += f[1] * ls.weight[1] * w;
            L[2] += f[2] * ls.weight[2] * w;
          }
        }
      }
    }

    // directional bounce
    let dNew; let pdfDir; let weight; let nextDelta = false;
    if (isGlass) {
      [dNew, weight] = this.glassSample(tri, ng, d, rng);
      pdfDir = 1.0;                 // discrete pdf; MIS never uses it
      nextDelta = true;
    } else {
      const res = this.bsdfSample(tri, n, d, rng, uv);
      if (res === null) return L;
      [dNew, pdfDir, weight, nextDelta] = res;
    }
    if (Math.max(weight[0], weight[1], weight[2]) <= 0) return L;
    const oNew = this.offset(pHit, ng, dNew);
    const Ln = this.radiance(oNew, dNew, rng, k + 1, pdfDir, nextDelta,
                             !smooth);
    L[0] += weight[0] * Ln[0];
    L[1] += weight[1] * Ln[1];
    L[2] += weight[2] * Ln[2];
    return L;
  }

  /* One sample per pixel over the block, accumulated (lib.rs:198-219). */
  renderBlock(x0, y0, sx, sy, pass) {
    const xe = Math.min(x0 + sx, this.width);
    const ye = Math.min(y0 + sy, this.height);
    for (let y = y0; y < ye; y++) {
      for (let x = x0; x < xe; x++) {
        const rng = pixelRng(x, y, pass, this.seed);
        const [o, d] = this.cameraRay(x + rng(), y + rng());
        const li = this.radiance(o, d, rng, 0, 1.0, true, false);
        const idx = y * this.width + x;
        if (isFinite(li[0]) && isFinite(li[1]) && isFinite(li[2]) &&
            li[0] >= 0 && li[1] >= 0 && li[2] >= 0) {
          this.img[idx * 3 + 0] += li[0];
          this.img[idx * 3 + 1] += li[1];
          this.img[idx * 3 + 2] += li[2];
          this.img2[idx * 3 + 0] += li[0] * li[0];
          this.img2[idx * 3 + 1] += li[1] * li[1];
          this.img2[idx * 3 + 2] += li[2] * li[2];
        }
        this.nbSamples[idx] += 1;
      }
    }
  }

  /* Gamma-2.2 running average to the canvas (lib.rs:221-232). */
  getImg(ctx) {
    const W = this.width; const H = this.height;
    const data = new Uint8ClampedArray(W * H * 4);
    for (let i = 0; i < W * H; i++) {
      const ns = this.nbSamples[i];
      if (ns !== 0) {
        const inv = 1.0 / ns;
        for (let c = 0; c < 3; c++) {
          data[i * 4 + c] = Math.min(
            Math.pow(this.img[i * 3 + c] * inv, 1.0 / 2.2), 1.0) * 255.0;
        }
      }
      data[i * 4 + 3] = 255;
    }
    ctx.putImageData(new ImageData(data, W, H), 0, 0);
  }

  /* Linear mean film (validation hook for the agreement artifact). */
  meanLinear() {
    const out = new Float64Array(this.img.length);
    for (let i = 0; i < this.nbSamples.length; i++) {
      const ns = Math.max(this.nbSamples[i], 1);
      out[i * 3] = this.img[i * 3] / ns;
      out[i * 3 + 1] = this.img[i * 3 + 1] / ns;
      out[i * 3 + 2] = this.img[i * 3 + 2] / ns;
    }
    return out;
  }

  /* Per-pixel per-channel variance OF THE MEAN: s^2/n with the unbiased
   * sample variance from the (sum, sum-of-squares) accumulators. */
  varOfMean() {
    const out = new Float64Array(this.img.length);
    for (let i = 0; i < this.nbSamples.length; i++) {
      const n = this.nbSamples[i];
      if (n < 2) continue;
      for (let c = 0; c < 3; c++) {
        const m = this.img[i * 3 + c] / n;
        const s2 = Math.max(
          (this.img2[i * 3 + c] - n * m * m) / (n - 1), 0.0);
        out[i * 3 + c] = s2 / n;
      }
    }
    return out;
  }

  spp() {
    let m = Infinity;
    for (let i = 0; i < this.nbSamples.length; i++) {
      if (this.nbSamples[i] < m) m = this.nbSamples[i];
    }
    return m === Infinity ? 0 : m;
  }
}

function dot(a, b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }
function cross(a, b) {
  return [a[1] * b[2] - a[2] * b[1],
          a[2] * b[0] - a[0] * b[2],
          a[0] * b[1] - a[1] * b[0]];
}
function norm(v) {
  const l = Math.hypot(v[0], v[1], v[2]);
  return [v[0] / l, v[1] / l, v[2] / l];
}
function balance(pdfA, pdfB) {
  return pdfA <= 0 ? 0.0 : pdfA / (pdfA + pdfB);
}

if (typeof window !== 'undefined') {
  window.WebScene = WebScene;
  window.__webTracerRng = { mulberry32, pixelRng };
}
