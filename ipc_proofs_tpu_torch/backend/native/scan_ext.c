/* Native Phase-A scanner: receipts AMT -> events AMTs -> flat event tensors.
 *
 * The port's copy of ipc_proofs_tpu/backend/native/scan_ext.c, built as
 * the module ipc_torch_scan_ext so a process can hold both copies. Its
 * verify_blake2b_blocks is left out: in the port, witness and TxMeta CID
 * recomputes run on the card's blake2b kernels (backend/gpu.py).
 *
 * The host side of pass 1 of the event-proof generator (the reference's
 * hottest loop, src/proofs/events/generator.rs:206-239) decodes every event
 * of every receipt.  The pure-Python path materializes Receipt/StampedEvent/
 * EventEntry objects per event; this extension walks the raw IPLD blocks
 * directly and emits the padded arrays the device match kernel consumes
 * (topics u32[N,2,8], n_topics, emitters, valid, pair/receipt/event ids) —
 * no per-event Python objects anywhere.
 *
 * Block access: a dict {cid_bytes: block_bytes} (fast path, C dict lookup)
 * plus an optional fallback callable(cid_bytes)->bytes|None for stores that
 * cannot expose a raw map (RPC-backed).  The scanner never records — pass 1
 * is deliberately witness-free, matching the reference's throwaway recorder.
 *
 * Build: gcc -O2 -shared -fPIC -I<python-include> scan_ext.c -o ipc_torch_scan_ext.so
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

/* ---------------- CBOR primitives (DAG-CBOR subset) ---------------- */

typedef struct {
  const uint8_t *data;
  Py_ssize_t len;
  Py_ssize_t pos;
} Parser;

/* ---------------- error channel ----------------
 *
 * The walk path must be callable WITHOUT the GIL (the parallel scan fans
 * roots out over pthreads), so parse/walk errors are recorded in a
 * thread-local slot instead of the Python error indicator; API boundaries
 * convert via raise_walk_err() with the GIL held.  A live Python exception
 * (e.g. raised by a fallback callable) always takes precedence. */

enum { E_NONE = 0, E_VALUE, E_KEY, E_TYPE, E_OVERFLOW, E_MEM };

typedef struct {
  int kind;
  char msg[120];
} WalkErr;

static _Thread_local WalkErr t_err;

static int walk_err(int kind, const char *msg) {
  if (t_err.kind == E_NONE) {
    t_err.kind = kind;
    strncpy(t_err.msg, msg, sizeof(t_err.msg) - 1);
    t_err.msg[sizeof(t_err.msg) - 1] = 0;
  }
  return -1;
}

static void raise_err(const WalkErr *err) {
  if (PyErr_Occurred()) return;
  switch (err->kind) {
    case E_KEY: PyErr_SetString(PyExc_KeyError, err->msg); return;
    case E_TYPE: PyErr_SetString(PyExc_TypeError, err->msg); return;
    case E_OVERFLOW: PyErr_SetString(PyExc_OverflowError, err->msg); return;
    case E_MEM: PyErr_NoMemory(); return;
    case E_VALUE: PyErr_SetString(PyExc_ValueError, err->msg); return;
    default: PyErr_SetString(PyExc_RuntimeError, "native scan failed"); return;
  }
}

static void raise_walk_err(void) { raise_err(&t_err); }

/* is the pending failure the per-group-degradable kind (scalar parity:
 * caught KeyError/ValueError)?  Checks the real indicator first. */
static int walk_err_degradable(void) {
  if (PyErr_Occurred())
    return PyErr_ExceptionMatches(PyExc_KeyError) ||
           PyErr_ExceptionMatches(PyExc_ValueError);
  return t_err.kind == E_VALUE || t_err.kind == E_KEY || t_err.kind == E_NONE;
}

static void walk_err_clear(void) {
  t_err.kind = E_NONE;
  if (PyErr_Occurred()) PyErr_Clear();
}

static int rd_head(Parser *p, int *major, uint64_t *value) {
  if (p->pos >= p->len) {
    walk_err(E_VALUE, "truncated CBOR head");
    return -1;
  }
  uint8_t byte = p->data[p->pos++];
  *major = byte >> 5;
  uint8_t info = byte & 0x1f;
  if (info < 24) {
    *value = info;
    return 0;
  }
  int extra;
  switch (info) {
    case 24: extra = 1; break;
    case 25: extra = 2; break;
    case 26: extra = 4; break;
    case 27: extra = 8; break;
    default:
      walk_err(E_VALUE, "indefinite CBOR length in DAG-CBOR");
      return -1;
  }
  if (p->pos + extra > p->len) {
    walk_err(E_VALUE, "truncated CBOR head");
    return -1;
  }
  uint64_t v = 0;
  for (int i = 0; i < extra; i++) v = (v << 8) | p->data[p->pos++];
  *value = v;
  return info;
}

/* strict UTF-8 (same table as the decoders: no overlongs, no surrogates,
 * max U+10FFFF) — validating skip must reject exactly what they reject */
static int scan_utf8_valid(const uint8_t *s, Py_ssize_t n) {
  Py_ssize_t i = 0;
  while (i < n) {
    uint8_t c = s[i];
    if (c < 0x80) {
      i++;
    } else if (c < 0xC2) {
      return 0;
    } else if (c < 0xE0) {
      if (i + 1 >= n || (s[i + 1] & 0xC0) != 0x80) return 0;
      i += 2;
    } else if (c < 0xF0) {
      if (i + 2 >= n || (s[i + 1] & 0xC0) != 0x80 || (s[i + 2] & 0xC0) != 0x80)
        return 0;
      if (c == 0xE0 && s[i + 1] < 0xA0) return 0;
      if (c == 0xED && s[i + 1] >= 0xA0) return 0;
      i += 3;
    } else if (c < 0xF5) {
      if (i + 3 >= n || (s[i + 1] & 0xC0) != 0x80 ||
          (s[i + 2] & 0xC0) != 0x80 || (s[i + 3] & 0xC0) != 0x80)
        return 0;
      if (c == 0xF0 && s[i + 1] < 0x90) return 0;
      if (c == 0xF4 && s[i + 1] >= 0x90) return 0;
      i += 4;
    } else {
      return 0;
    }
  }
  return 1;
}

/* VALIDATING skip, mirroring the decoders' DAG-CBOR acceptance (strict
 * UTF-8 text, string map keys, only tag 42 with structurally valid CID
 * bytes, only simple values false/true/null and f64). The lax skip this
 * replaced let a witness block hide garbage in positions the targeted
 * walk skips (receipt return_data, sibling entries) that the scalar
 * replay's full decode rejects — a batch-accepts/scalar-rejects verdict
 * divergence. The explicit depth budget also bounds recursion: the old
 * skip recursed per nesting level with no cap, so a crafted block of tens
 * of thousands of nested arrays could overflow the C stack. */
#define SCAN_MAX_CBOR_DEPTH 512

static int scan_cid_valid(const uint8_t *d, Py_ssize_t n);

static int skip_item_d(Parser *p, int depth) {
  if (depth >= SCAN_MAX_CBOR_DEPTH)
    return walk_err(E_VALUE, "CBOR nesting too deep");
  int major;
  uint64_t value;
  int info = rd_head(p, &major, &value);
  if (info < 0) return -1;
  switch (major) {
    case 0:
    case 1:
      return 0;
    case 2:
      /* unsigned compare: a crafted length >= 2^63 must fail here, not
       * wrap the signed cast and drive pos negative (OOB read) */
      if ((uint64_t)(p->len - p->pos) < value)
        return walk_err(E_VALUE, "truncated CBOR bytes/text");
      p->pos += (Py_ssize_t)value;
      return 0;
    case 3:
      if ((uint64_t)(p->len - p->pos) < value)
        return walk_err(E_VALUE, "truncated CBOR bytes/text");
      if (!scan_utf8_valid(p->data + p->pos, (Py_ssize_t)value))
        return walk_err(E_VALUE, "invalid UTF-8 in CBOR text");
      p->pos += (Py_ssize_t)value;
      return 0;
    case 4:
      if ((uint64_t)(p->len - p->pos) < value)
        return walk_err(E_VALUE, "CBOR array length exceeds input");
      for (uint64_t i = 0; i < value; i++)
        if (skip_item_d(p, depth + 1) < 0) return -1;
      return 0;
    case 5:
      for (uint64_t i = 0; i < value; i++) {
        Py_ssize_t key_at = p->pos;
        if (skip_item_d(p, depth + 1) < 0) return -1;
        if ((p->data[key_at] >> 5) != 3)
          return walk_err(E_VALUE, "DAG-CBOR map keys must be strings");
        if (skip_item_d(p, depth + 1) < 0) return -1;
      }
      return 0;
    case 6: {
      if (value != 42) return walk_err(E_VALUE, "unsupported CBOR tag");
      /* tag content consumes a nesting level in BOTH decoders (native
       * depth_enter, Python depth + 1) — budget it here too, or blocks
       * at the 512-depth boundary validate clean while the scalar decode
       * rejects them */
      if (depth + 1 >= SCAN_MAX_CBOR_DEPTH)
        return walk_err(E_VALUE, "CBOR nesting too deep");
      int imajor;
      uint64_t ival;
      if (rd_head(p, &imajor, &ival) < 0) return -1;
      if (imajor != 2)
        return walk_err(E_VALUE,
                        "tag-42 content must be identity-multibase CID bytes");
      if ((uint64_t)(p->len - p->pos) < ival)
        return walk_err(E_VALUE, "truncated CBOR bytes/text");
      const uint8_t *content = p->data + p->pos;
      p->pos += (Py_ssize_t)ival;
      if (ival < 1 || content[0] != 0)
        return walk_err(E_VALUE,
                        "tag-42 content must be identity-multibase CID bytes");
      if (!scan_cid_valid(content + 1, (Py_ssize_t)ival - 1))
        return walk_err(E_VALUE, "malformed CID bytes in tag 42");
      return 0;
    }
    case 7:
      if (info == 27 || value == 20 || value == 21 || value == 22) return 0;
      return walk_err(E_VALUE, "unsupported CBOR simple value");
  }
  return walk_err(E_VALUE, "unreachable CBOR major");
}

static int skip_item(Parser *p) { return skip_item_d(p, 0); }

/* full-block validation: the whole block must be ONE well-formed DAG-CBOR
 * item with nothing trailing — exactly what the scalar paths establish by
 * cbor_decode()ing every block they load. Applied per fetched block on
 * the verify-side walkers (Scan.validate). */
static int validate_block(const uint8_t *data, Py_ssize_t len) {
  Parser q = {data, len, 0};
  if (skip_item_d(&q, 0) < 0) return -1;
  if (q.pos != q.len)
    return walk_err(E_VALUE, "trailing bytes after CBOR item");
  return 0;
}

/* expect an array head, return its length */
static int rd_array(Parser *p, uint64_t *n) {
  int major;
  if (rd_head(p, &major, n) < 0) return -1;
  if (major != 4) {
    walk_err(E_VALUE, "expected CBOR array");
    return -1;
  }
  return 0;
}

/* expect bytes, return span */
static int rd_bytes(Parser *p, const uint8_t **ptr, Py_ssize_t *blen) {
  int major;
  uint64_t value;
  if (rd_head(p, &major, &value) < 0) return -1;
  /* unsigned compare — a length >= 2^63 must fail, not wrap the cast */
  if (major != 2 || (uint64_t)(p->len - p->pos) < value) {
    walk_err(E_VALUE, "expected CBOR bytes");
    return -1;
  }
  *ptr = p->data + p->pos;
  *blen = (Py_ssize_t)value;
  p->pos += (Py_ssize_t)value;
  return 0;
}

/* expect uint, return value */
static int rd_uint(Parser *p, uint64_t *value) {
  int major;
  if (rd_head(p, &major, value) < 0) return -1;
  if (major != 0) {
    walk_err(E_VALUE, "expected CBOR uint");
    return -1;
  }
  return 0;
}

/* uvarint with the same acceptance as core/varint.decode_uvarint (shift
 * capped so values stay under 2^70) */
static int scan_cid_uvarint(const uint8_t *d, Py_ssize_t n, Py_ssize_t *pos,
                            unsigned __int128 *out) {
  unsigned __int128 value = 0;
  int shift = 0;
  for (;;) {
    if (*pos >= n) return -1; /* truncated uvarint */
    uint8_t b = d[(*pos)++];
    value |= (unsigned __int128)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = value;
      return 0;
    }
    shift += 7;
    if (shift > 63) return -1; /* uvarint too long */
  }
}

/* scan_cid_uvarint + strict minimality: a multi-byte varint whose final
 * (most-significant) byte is zero is a second encoding of the same value
 * and rejects, exactly like CID.from_bytes / go-varint / unsigned-varint */
static int scan_cid_uvarint_min(const uint8_t *d, Py_ssize_t n,
                                Py_ssize_t *pos, unsigned __int128 *out) {
  Py_ssize_t start = *pos;
  if (scan_cid_uvarint(d, n, pos, out) < 0) return -1;
  if (*pos - start > 1 && d[*pos - 1] == 0) return -1; /* non-minimal */
  return 0;
}

/* structural CID validation, mirroring CID.from_bytes acceptance (version
 * must be 1; minimal varints; digest length must equal the mh_len varint;
 * no trailing bytes). The Python decoders validate EVERY CID in a node
 * they decode, so the scanner must reject the same bytes — otherwise a
 * witness node whose unrelated sibling entry carries a corrupt CID scans
 * clean here while the scalar replay rejects it, and the two verify paths
 * diverge (found by tests/test_batch_verifier_fuzz.py; the minimality leg
 * by the round-5 exec-order fuzz: a non-minimal link varint made this
 * walker's raw span disagree with the scalar canonical re-encode). */
static int scan_cid_valid(const uint8_t *d, Py_ssize_t n) {
  Py_ssize_t pos = 0;
  unsigned __int128 version, codec, mh_code, mh_len;
  if (scan_cid_uvarint_min(d, n, &pos, &version) < 0 || version != 1) return 0;
  if (scan_cid_uvarint_min(d, n, &pos, &codec) < 0) return 0;
  if (scan_cid_uvarint_min(d, n, &pos, &mh_code) < 0) return 0;
  if (scan_cid_uvarint_min(d, n, &pos, &mh_len) < 0) return 0;
  return (unsigned __int128)(n - pos) == mh_len;
}

/* tag-42 CID: returns span of cid bytes (multibase 0x00 stripped), or
 * no-CID (ok=0) when the item is null.  Errors set an exception. */
static int rd_cid_or_null(Parser *p, const uint8_t **ptr, Py_ssize_t *clen, int *ok) {
  int major;
  uint64_t value;
  int info = rd_head(p, &major, &value);
  if (info < 0) return -1;
  if (major == 7 && value == 22) { /* null */
    *ok = 0;
    return 0;
  }
  if (major != 6 || value != 42) {
    walk_err(E_VALUE, "expected CID or null");
    return -1;
  }
  const uint8_t *raw;
  Py_ssize_t rlen;
  if (rd_bytes(p, &raw, &rlen) < 0) return -1;
  if (rlen < 2 || raw[0] != 0) {
    walk_err(E_VALUE, "tag-42 must hold identity-multibase CID");
    return -1;
  }
  if (!scan_cid_valid(raw + 1, rlen - 1)) {
    walk_err(E_VALUE, "malformed CID bytes in tag 42");
    return -1;
  }
  *ptr = raw + 1;
  *clen = rlen - 1;
  *ok = 1;
  return 0;
}

/* ---------------- growable output buffers ---------------- */

typedef struct {
  uint8_t *buf;
  size_t len, cap;
} Vec;

/* plain malloc/realloc: vec operations must be legal without the GIL */
static int vec_reserve(Vec *v, size_t need) {
  if (need <= v->cap) return 0;
  size_t cap = v->cap ? v->cap * 2 : 4096;
  while (cap < need) cap *= 2;
  uint8_t *nb = realloc(v->buf, cap);
  if (!nb) return walk_err(E_MEM, "out of memory");
  v->buf = nb;
  v->cap = cap;
  return 0;
}

static int vec_push(Vec *v, const void *src, size_t n) {
  /* empty source vecs have buf == NULL, and memcpy(dst, NULL, 0) is UB */
  if (n == 0) return 0;
  if (vec_reserve(v, v->len + n) < 0) return -1;
  memcpy(v->buf + v->len, src, n);
  v->len += n;
  return 0;
}

static void vec_free(Vec *v) {
  free(v->buf);
  v->buf = NULL;
}

typedef struct {
  Vec topics;   /* u32[2][8] per event (64 B) */
  Vec fp;       /* u64 per event: FNV-1a over the 64 topic bytes (the
                 * transfer-light device-match input; see scan_native.py) */
  Vec n_topics; /* i32 */
  Vec emitters; /* u64 */
  Vec valid;    /* u8 */
  Vec pair_ids; /* i32 */
  Vec exec_idx; /* i32 */
  Vec event_idx;/* i32 */
  /* payload mode (verification): full topics / data bytes, pooled */
  Vec topics_pool;
  Vec data_pool;
  Vec topics_off; /* u32 per event: start offset into topics_pool */
  Vec data_off;   /* u32 per event: start offset into data_pool */
  Vec data_len;   /* u32 per event */
  /* fused-match mode: evaluate the fp predicate per event IN the walk and
   * emit only the matching (pair_id, receipt_idx) rows — no per-event
   * columns at all. Same predicate as the host/device fp mask
   * (backend/tpu.py event_match_mask_fp): valid && n_topics >= 2 &&
   * fp == match_fp && (no actor filter || emitter == match_actor). Pass 2
   * confirms every hit exactly, so fp collisions stay harmless. */
  int match_mode;
  uint64_t match_fp;
  int match_has_actor;
  uint64_t match_actor;
  Vec hit_pairs; /* i32 per hit */
  Vec hit_exec;  /* i32 per hit */
  int64_t n_events;
  int64_t ev_cap;     /* row capacity of the fixed-width event columns */
  int64_t n_receipts; /* receipts with an events root, across all pairs */
  PyObject *blocks;   /* borrowed: dict {cid_bytes: block_bytes} */
  PyObject *fallback; /* borrowed: callable(cid_bytes)->bytes|None, or NULL */
  const struct CMap *cmap; /* optional GIL-free snapshot of `blocks` */
  int skip_missing;   /* 1 = prune subtrees whose blocks are absent */
  int want_payload;   /* 1 = fill the payload pools */
  int validate;       /* 1 = full-block DAG-CBOR validation per fetch
                       * (verify-side callers: adversarial witness bytes
                       * must not scan clean where the scalar replay's
                       * full decode rejects them). Validation re-runs on
                       * re-fetches of the same block; today's verify-side
                       * callers walk <= 1 key/path per root, so the
                       * redundancy is bounded — add a per-Scan seen-memo
                       * before pointing a many-keys-per-root caller at
                       * this flag. */
  /* optional touched-block recording (the exec-order walker's witness leg):
   * every successful get_block appends (offset, len) + cid bytes */
  Vec *touch_pool;
  Vec *touch_off;
  Vec *touch_len;
} Scan;

/* offset vectors are int32/uint32; reject pools that would wrap rather than
 * silently corrupting slices (plausible at pod-scale ranges). */
static int pool_off_ok(size_t len, size_t max) {
  if (len > max)
    return walk_err(E_OVERFLOW, "pooled bytes exceed offset range (>2 GiB pool)");
  return 0;
}

/* ---------------- GIL-free block map snapshot ----------------
 *
 * The parallel scan threads cannot touch the Python dict; cmap_build
 * snapshots it (borrowed pointers into live bytes objects — the caller
 * keeps the dict alive AND unmutated for the call's duration; the
 * multi-thread fan-out runs without the GIL, so a concurrent `del
 * blocks[k]` from another Python thread would free a borrowed buffer.
 * The single-chunk path holds the GIL throughout, closing that window)
 * into an open-addressing table that cmap_get probes without the GIL. */

typedef struct {
  const uint8_t *key;
  Py_ssize_t klen;
  const uint8_t *val;
  Py_ssize_t vlen; /* -2 = value is not bytes (lazily errors, dict parity) */
  PyObject *kobj;  /* strong refs (persistent snapshots only): a put_keyed
                    * overwrite swaps in a NEW equal-content bytes object
                    * and drops the old one — borrowed val pointers would
                    * dangle across calls. Transient builds leave NULL. */
  PyObject *vobj;
} CEntry;

typedef struct CMap {
  CEntry *slots;
  size_t mask; /* capacity - 1, capacity a power of two */
  int strong;  /* 1 = entries hold kobj/vobj references (persistent) */
} CMap;

static uint64_t cmap_hash(const uint8_t *d, Py_ssize_t n) {
  /* CID keys END in a cryptographic digest — the last 8 bytes are already
   * uniformly distributed, so one unaligned load beats hashing all 38 */
  if (n >= 8) {
    uint64_t h;
    memcpy(&h, d + n - 8, 8);
    return h * 0x9E3779B97F4A7C15ULL;
  }
  uint64_t h = 1469598103934665603ULL;
  for (Py_ssize_t i = 0; i < n; i++) {
    h ^= d[i];
    h *= 1099511628211ULL;
  }
  return h;
}

static int cmap_build(CMap *m, PyObject *dict, int strong) {
  Py_ssize_t n = PyDict_Size(dict);
  size_t cap = 16;
  while (cap < (size_t)n * 2 + 1) cap <<= 1;
  m->slots = calloc(cap, sizeof(CEntry));
  if (!m->slots) return walk_err(E_MEM, "out of memory");
  m->mask = cap - 1;
  m->strong = strong;
  PyObject *k, *v;
  Py_ssize_t pos = 0;
  while (PyDict_Next(dict, &pos, &k, &v)) {
    /* non-bytes keys can never equal a CID-bytes lookup — skip */
    if (!PyBytes_Check(k)) continue;
    CEntry e;
    e.key = (const uint8_t *)PyBytes_AS_STRING(k);
    e.klen = PyBytes_GET_SIZE(k);
    if (PyBytes_Check(v)) {
      e.val = (const uint8_t *)PyBytes_AS_STRING(v);
      e.vlen = PyBytes_GET_SIZE(v);
    } else {
      e.val = NULL;
      e.vlen = -2;
    }
    if (strong) {
      Py_INCREF(k);
      Py_INCREF(v);
      e.kobj = k;
      e.vobj = v;
    } else {
      e.kobj = NULL;
      e.vobj = NULL;
    }
    size_t i = cmap_hash(e.key, e.klen) & m->mask;
    while (m->slots[i].key) i = (i + 1) & m->mask;
    m->slots[i] = e;
  }
  return 0;
}

static void cmap_free(CMap *m) {
  if (m->slots && m->strong) {
    for (size_t i = 0; i <= m->mask; i++) {
      Py_XDECREF(m->slots[i].kobj);
      Py_XDECREF(m->slots[i].vobj);
    }
  }
  free(m->slots);
  m->slots = NULL;
}

static const CEntry *cmap_get(const CMap *m, const uint8_t *key,
                              Py_ssize_t klen) {
  size_t i = cmap_hash(key, klen) & m->mask;
  while (m->slots[i].key) {
    if (m->slots[i].klen == klen && memcmp(m->slots[i].key, key, klen) == 0)
      return &m->slots[i];
    i = (i + 1) & m->mask;
  }
  return NULL;
}

/* ---------------- persistent snapshot (BlockSnapshot) ----------------
 *
 * cmap_build is O(|dict|) — at range scale (~100k blocks) it costs about
 * as much as the probe savings it buys, paid again by EVERY native call.
 * A BlockSnapshot makes the table a first-class Python object the driver
 * builds once per store and passes to every walker: content-addressed
 * stores only ever ADD blocks, so a cached snapshot's hits stay valid
 * forever (entries hold strong refs — see CEntry.kobj) and misses fall
 * through to the live dict probe in get_block. Wrappers rebuild on the
 * store's MUTATION COUNTER (size alone would miss same-size overwrites);
 * the multi-thread arm additionally requires the snapshot to be complete
 * (size equal) since jobs cannot touch the dict. */

typedef struct {
  PyObject_HEAD
  PyObject *dict;   /* the snapshotted block dict (strong) */
  CMap map;         /* strong entries */
  Py_ssize_t built; /* PyDict_Size at build time (freshness stamp) */
} SnapshotObj;

static PyTypeObject Snapshot_Type; /* fwd */

static void snapshot_dealloc(SnapshotObj *o) {
  PyObject_GC_UnTrack(o);
  cmap_free(&o->map);
  Py_XDECREF(o->dict);
  PyObject_GC_Del(o);
}

static int snapshot_traverse(SnapshotObj *o, visitproc visit, void *arg) {
  Py_VISIT(o->dict);
  /* the map's strong entries are real references (a non-bytes value or an
   * overwritten one may be held ONLY here) — invisible refs would make
   * cycles through them uncollectable */
  if (o->map.slots && o->map.strong) {
    for (size_t i = 0; i <= o->map.mask; i++) {
      Py_VISIT(o->map.slots[i].kobj);
      Py_VISIT(o->map.slots[i].vobj);
    }
  }
  return 0;
}

static int snapshot_clear_(SnapshotObj *o) {
  Py_CLEAR(o->dict);
  cmap_free(&o->map);
  return 0;
}

static PyObject *snapshot_get_n_blocks(SnapshotObj *o, void *c) {
  (void)c;
  return PyLong_FromSsize_t(o->built);
}

static PyGetSetDef snapshot_getset[] = {
    {"n_blocks", (getter)snapshot_get_n_blocks, NULL,
     "dict size at build time (freshness stamp)", NULL},
    {NULL, NULL, NULL, NULL, NULL}};

static PyTypeObject Snapshot_Type = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "ipc_torch_scan_ext.BlockSnapshot",
    .tp_basicsize = sizeof(SnapshotObj),
    .tp_dealloc = (destructor)snapshot_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC,
    .tp_traverse = (traverseproc)snapshot_traverse,
    .tp_clear = (inquiry)snapshot_clear_,
    .tp_getset = snapshot_getset,
    .tp_doc = "GIL-free block-map snapshot reusable across native walks",
};

/* bulk_load_blocks(blocks, cid_dict, raw_dict) -> count: the witness
 * loader's hot loop (per ProofBlock: cid/data attribute reads, the
 * memoized cid.to_bytes(), and two dict inserts) in one C pass. `data`
 * values must already be bytes (ProofBlock holds bytes by construction);
 * a non-bytes data raises TypeError with nothing half-loaded beyond the
 * items before it — identical to the Python loop's bytes() failure. */
static PyObject *py_bulk_load_blocks(PyObject *self, PyObject *args) {
  (void)self;
  PyObject *blocks, *cid_dict, *raw_dict;
  if (!PyArg_ParseTuple(args, "OO!O!", &blocks, &PyDict_Type, &cid_dict,
                        &PyDict_Type, &raw_dict))
    return NULL;
  PyObject *seq = PySequence_Fast(blocks, "blocks must be a sequence");
  if (!seq) return NULL;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  PyObject *name_cid = PyUnicode_InternFromString("cid");
  PyObject *name_data = PyUnicode_InternFromString("data");
  PyObject *name_to_bytes = PyUnicode_InternFromString("to_bytes");
  if (!name_cid || !name_data || !name_to_bytes) goto fail;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *block = PySequence_Fast_GET_ITEM(seq, i);
    PyObject *cid = PyObject_GetAttr(block, name_cid);
    if (!cid) goto fail;
    PyObject *data = PyObject_GetAttr(block, name_data);
    if (!data) {
      Py_DECREF(cid);
      goto fail;
    }
    if (!PyBytes_CheckExact(data)) {
      /* mirror bytes(block.data): accept anything the buffer protocol
       * accepts by falling back to PyBytes_FromObject. CheckExact (not
       * Check) so bytes SUBCLASSES are normalized to exact bytes too —
       * the Python fallback's bytes(data) does, and the two loaders must
       * store byte-identical object types (ADVICE.md #5) */
      PyObject *converted = PyBytes_FromObject(data);
      Py_DECREF(data);
      if (!converted) {
        Py_DECREF(cid);
        goto fail;
      }
      data = converted;
    }
    PyObject *key = PyObject_CallMethodNoArgs(cid, name_to_bytes);
    if (!key) {
      Py_DECREF(cid);
      Py_DECREF(data);
      goto fail;
    }
    int rc = PyDict_SetItem(cid_dict, cid, data);
    if (rc == 0) rc = PyDict_SetItem(raw_dict, key, data);
    Py_DECREF(cid);
    Py_DECREF(data);
    Py_DECREF(key);
    if (rc < 0) goto fail;
  }
  Py_DECREF(name_cid);
  Py_DECREF(name_data);
  Py_DECREF(name_to_bytes);
  Py_DECREF(seq);
  return PyLong_FromSsize_t(n);
fail:
  Py_XDECREF(name_cid);
  Py_XDECREF(name_data);
  Py_XDECREF(name_to_bytes);
  Py_DECREF(seq);
  return NULL;
}

static PyObject *py_make_snapshot(PyObject *self, PyObject *arg) {
  (void)self;
  if (!PyDict_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "make_snapshot expects a dict");
    return NULL;
  }
  SnapshotObj *o = PyObject_GC_New(SnapshotObj, &Snapshot_Type);
  if (!o) return NULL;
  o->dict = NULL;
  o->map.slots = NULL;
  o->map.mask = 0;
  o->map.strong = 0;
  o->built = 0;
  t_err.kind = E_NONE;
  if (cmap_build(&o->map, arg, 1) < 0) {
    PyObject_GC_Del(o);
    raise_walk_err();
    return NULL;
  }
  Py_INCREF(arg);
  o->dict = arg;
  o->built = PyDict_Size(arg);
  PyObject_GC_Track(o);
  return (PyObject *)o;
}

/* Resolve an optional snapshot= argument against the call's block dict.
 * Returns 0 on success (*out set, NULL when snapshot is None;
 * *out_complete set when the pointer is non-NULL — only the threaded scan
 * arm cares), -1 with an exception for type or dict-identity misuse. */
static int snapshot_resolve(PyObject *snap_obj, PyObject *blocks,
                            const CMap **out, int *out_complete) {
  *out = NULL;
  if (out_complete) *out_complete = 0;
  if (!snap_obj || snap_obj == Py_None) return 0;
  if (!PyObject_TypeCheck(snap_obj, &Snapshot_Type)) {
    PyErr_SetString(PyExc_TypeError, "snapshot must be a BlockSnapshot");
    return -1;
  }
  SnapshotObj *sn = (SnapshotObj *)snap_obj;
  if (sn->dict != blocks) {
    PyErr_SetString(PyExc_ValueError,
                    "snapshot was built over a different block dict");
    return -1;
  }
  *out = &sn->map;
  if (out_complete) *out_complete = PyDict_Size(blocks) == sn->built;
  return 0;
}

/* a fetched block: data/len always valid on success; obj non-NULL iff a
 * reference is held (dict/fallback path) and must be block_release()d */
typedef struct {
  PyObject *obj;
  const uint8_t *data;
  Py_ssize_t len;
} BlockRef;

static void block_release(BlockRef *b) {
  Py_XDECREF(b->obj);
  b->obj = NULL;
}

static int record_touch(Scan *s, const uint8_t *cid, Py_ssize_t clen) {
  if (!s->touch_pool) return 0;
  if (pool_off_ok(s->touch_pool->len, INT32_MAX) < 0) return -1;
  int32_t off = (int32_t)s->touch_pool->len;
  int32_t len = (int32_t)clen;
  if (vec_push(s->touch_off, &off, 4) < 0) return -1;
  if (vec_push(s->touch_len, &len, 4) < 0) return -1;
  return vec_push(s->touch_pool, cid, (size_t)clen);
}

/* fetch a block: 1 = ok, 0 = missing + skip_missing (prune), -1 = error. */
static int get_block(Scan *s, const uint8_t *cid, Py_ssize_t clen,
                     BlockRef *out) {
  out->obj = NULL;
  if (record_touch(s, cid, clen) < 0) return -1;
  if (s->cmap) { /* GIL-free path */
    const CEntry *e = cmap_get(s->cmap, cid, clen);
    if (e) {
      if (e->vlen == -2)
        return walk_err(E_TYPE, "block map values must be bytes");
      out->data = e->val;
      out->len = e->vlen;
      if (s->validate && validate_block(out->data, out->len) < 0) return -1;
      return 1;
    }
    /* miss: with the live dict in reach (GIL-held single-thread paths) fall
     * through to the dict probe — a persistent snapshot may be stale (the
     * content-addressed store only ever ADDS blocks, so hits above are
     * always valid and only new blocks can be missed). Threaded jobs have
     * s->blocks == NULL and keep the terminal miss semantics. */
    if (!s->blocks) {
      if (s->skip_missing) return 0;
      return walk_err(E_KEY, "missing block");
    }
  }
  PyObject *key = PyBytes_FromStringAndSize((const char *)cid, clen);
  if (!key) return -1;
  PyObject *hit = PyDict_GetItemWithError(s->blocks, key);
  if (hit) {
    Py_INCREF(hit);
    Py_DECREF(key);
    if (!PyBytes_Check(hit)) {
      Py_DECREF(hit);
      return walk_err(E_TYPE, "block map values must be bytes");
    }
    out->obj = hit;
    out->data = (const uint8_t *)PyBytes_AS_STRING(hit);
    out->len = PyBytes_GET_SIZE(hit);
    if (s->validate && validate_block(out->data, out->len) < 0) {
      block_release(out);
      return -1;
    }
    return 1;
  }
  if (PyErr_Occurred()) {
    Py_DECREF(key);
    return -1;
  }
  if (s->fallback && s->fallback != Py_None) {
    PyObject *res = PyObject_CallOneArg(s->fallback, key);
    Py_DECREF(key);
    if (!res) return -1;
    if (res == Py_None) {
      Py_DECREF(res);
      if (s->skip_missing) return 0;
      return walk_err(E_KEY, "missing block");
    }
    if (!PyBytes_Check(res)) {
      Py_DECREF(res);
      return walk_err(E_TYPE, "fallback get must return bytes");
    }
    out->obj = res;
    out->data = (const uint8_t *)PyBytes_AS_STRING(res);
    out->len = PyBytes_GET_SIZE(res);
    if (s->validate && validate_block(out->data, out->len) < 0) {
      block_release(out);
      return -1;
    }
    return 1;
  }
  Py_DECREF(key);
  if (s->skip_missing) return 0;
  return walk_err(E_KEY, "missing block");
}

/* ---------------- EVM log extraction (state/events.py parity) -------- */

/* one stamped event value: [emitter, [[flags,key,codec,value],...]] */
static int emit_event(Scan *s, Parser *p, int32_t pair_id, int32_t rcpt_idx,
                      int32_t ev_idx) {
  uint64_t n_fields;
  if (rd_array(p, &n_fields) < 0) return -1;
  if (n_fields != 2) {
    walk_err(E_VALUE, "StampedEvent must be a 2-tuple");
    return -1;
  }
  uint64_t emitter;
  if (rd_uint(p, &emitter) < 0) return -1;

  uint64_t n_entries;
  if (rd_array(p, &n_entries) < 0) return -1;

  /* spans; last occurrence wins (dict-comprehension parity) */
  const uint8_t *topics_ptr = NULL; Py_ssize_t topics_len = -1;
  const uint8_t *t_ptr[4] = {0}; Py_ssize_t t_len[4] = {-1, -1, -1, -1};
  const uint8_t *dataA_ptr = NULL; Py_ssize_t dataA_len = -1; /* "data" */
  const uint8_t *dataB_ptr = NULL; Py_ssize_t dataB_len = -1; /* "d" */

  for (uint64_t e = 0; e < n_entries; e++) {
    uint64_t entry_fields;
    if (rd_array(p, &entry_fields) < 0) return -1;
    if (entry_fields != 4) {
      walk_err(E_VALUE, "event entry must be a 4-tuple");
      return -1;
    }
    uint64_t flags_u64;
    if (rd_uint(p, &flags_u64) < 0) return -1; /* flags: u64 (serde parity) */
    int major;
    uint64_t klen;
    if (rd_head(p, &major, &klen) < 0) return -1;
    if (major != 3 || p->pos + (Py_ssize_t)klen > p->len) {
      walk_err(E_VALUE, "event entry key must be text");
      return -1;
    }
    const uint8_t *key = p->data + p->pos;
    p->pos += (Py_ssize_t)klen;
    uint64_t codec_u64;
    if (rd_uint(p, &codec_u64) < 0) return -1; /* codec: u64 (serde parity) */
    const uint8_t *vptr;
    Py_ssize_t vlen;
    if (rd_bytes(p, &vptr, &vlen) < 0) return -1; /* value (always bytes) */

    if (klen == 6 && memcmp(key, "topics", 6) == 0) {
      topics_ptr = vptr;
      topics_len = vlen;
    } else if (klen == 2 && key[0] == 't' && key[1] >= '1' && key[1] <= '4') {
      int k = key[1] - '1';
      t_ptr[k] = vptr;
      t_len[k] = vlen;
    } else if (klen == 4 && memcmp(key, "data", 4) == 0) {
      dataA_ptr = vptr;
      dataA_len = vlen;
    } else if (klen == 1 && key[0] == 'd') {
      dataB_ptr = vptr;
      dataB_len = vlen;
    }
  }

  uint8_t topic_words[64]; /* 2 topics x 32 B */
  memset(topic_words, 0, sizeof(topic_words));
  int32_t n_topics = 0;
  uint8_t valid = 0;
  int case_a = topics_len >= 0;

  if (case_a) { /* Case A: concatenated 32-byte chunks */
    if (topics_len % 32 == 0) {
      valid = 1;
      n_topics = (int32_t)(topics_len / 32);
      Py_ssize_t take = topics_len < 64 ? topics_len : 64;
      memcpy(topic_words, topics_ptr, take);
    }
  } else { /* Case B: compact t1..t4, stop at first missing */
    for (int k = 0; k < 4; k++) {
      if (t_len[k] < 0) break;
      if (t_len[k] != 32) {
        n_topics = 0; /* malformed -> not EVM-shaped (extract returns None) */
        valid = 0;
        goto done;
      }
      if (k < 2) memcpy(topic_words + 32 * k, t_ptr[k], 32);
      n_topics++;
    }
    valid = n_topics > 0;
  }

done:;
  /* word-wise 64-bit mix of the zero-padded 2x32B topic words — must match
   * scan_native.topic_fingerprint exactly (8 u64 LE rounds; a byte-serial
   * FNV's multiply chain dominated the per-event cost). ONE copy serves
   * both the fused-match predicate and the emitted fp column. */
  uint64_t fp = 0x9E3779B97F4A7C15ULL;
  for (int k = 0; k < 8; k++) {
    uint64_t w;
    memcpy(&w, topic_words + 8 * k, 8);
    fp = (fp ^ w) * 0xFF51AFD7ED558CCDULL;
    fp ^= fp >> 29;
  }
  if (s->match_mode) {
    /* fused match: no per-event output — one register compare per event,
     * hits are rare (north-star range: ~0.25 % of events) */
    if (valid && n_topics >= 2 && fp == s->match_fp &&
        (!s->match_has_actor || emitter == s->match_actor)) {
      if (vec_push(&s->hit_pairs, &pair_id, 4) < 0 ||
          vec_push(&s->hit_exec, &rcpt_idx, 4) < 0)
        return -1;
    }
    s->n_events++;
    return 0;
  }
  uint32_t toff = 0, doff = 0, dlen = 0;
  if (s->want_payload) {
    if (pool_off_ok(s->topics_pool.len, UINT32_MAX) < 0 ||
        pool_off_ok(s->data_pool.len, UINT32_MAX) < 0)
      return -1;
    toff = (uint32_t)s->topics_pool.len;
    doff = (uint32_t)s->data_pool.len;
    if (valid) {
      if (case_a) {
        if (vec_push(&s->topics_pool, topics_ptr, (size_t)topics_len) < 0)
          return -1;
        if (dataA_len > 0) {
          if (vec_push(&s->data_pool, dataA_ptr, (size_t)dataA_len) < 0)
            return -1;
          dlen = (uint32_t)dataA_len;
        }
      } else {
        for (int k = 0; k < n_topics; k++)
          if (vec_push(&s->topics_pool, t_ptr[k], 32) < 0) return -1;
        if (dataB_len > 0) {
          if (vec_push(&s->data_pool, dataB_ptr, (size_t)dataB_len) < 0)
            return -1;
          dlen = (uint32_t)dataB_len;
        }
      }
    }
  }
  /* fused row write: ONE capacity check per event instead of 8-11 pushes
   * (the scan emits hundreds of thousands of rows per range) */
  if (s->n_events == s->ev_cap) {
    size_t rows = s->ev_cap ? (size_t)s->ev_cap * 2 : 1024;
    if (vec_reserve(&s->topics, rows * 64) < 0 ||
        vec_reserve(&s->fp, rows * 8) < 0 ||
        vec_reserve(&s->n_topics, rows * 4) < 0 ||
        vec_reserve(&s->emitters, rows * 8) < 0 ||
        vec_reserve(&s->valid, rows) < 0 ||
        vec_reserve(&s->pair_ids, rows * 4) < 0 ||
        vec_reserve(&s->exec_idx, rows * 4) < 0 ||
        vec_reserve(&s->event_idx, rows * 4) < 0)
      return -1;
    if (s->want_payload &&
        (vec_reserve(&s->topics_off, rows * 4) < 0 ||
         vec_reserve(&s->data_off, rows * 4) < 0 ||
         vec_reserve(&s->data_len, rows * 4) < 0))
      return -1;
    s->ev_cap = (int64_t)rows;
  }
  size_t n = (size_t)s->n_events;
  memcpy(s->topics.buf + n * 64, topic_words, 64);
  ((uint64_t *)s->fp.buf)[n] = fp;
  ((int32_t *)s->n_topics.buf)[n] = n_topics;
  ((uint64_t *)s->emitters.buf)[n] = emitter;
  s->valid.buf[n] = valid;
  ((int32_t *)s->pair_ids.buf)[n] = pair_id;
  ((int32_t *)s->exec_idx.buf)[n] = rcpt_idx;
  ((int32_t *)s->event_idx.buf)[n] = ev_idx;
  s->topics.len = (n + 1) * 64;
  s->fp.len = (n + 1) * 8;
  s->n_topics.len = (n + 1) * 4;
  s->emitters.len = (n + 1) * 8;
  s->valid.len = n + 1;
  s->pair_ids.len = (n + 1) * 4;
  s->exec_idx.len = (n + 1) * 4;
  s->event_idx.len = (n + 1) * 4;
  if (s->want_payload) {
    ((uint32_t *)s->topics_off.buf)[n] = toff;
    ((uint32_t *)s->data_off.buf)[n] = doff;
    ((uint32_t *)s->data_len.buf)[n] = dlen;
    s->topics_off.len = (n + 1) * 4;
    s->data_off.len = (n + 1) * 4;
    s->data_len.len = (n + 1) * 4;
  }
  s->n_events++;
  return 0;
}

/* ---------------- AMT walk (ipld/amt.py parity) ---------------- */

typedef int (*leaf_fn)(Scan *s, Parser *p, int64_t index, void *ctx);

/* receipts-leaf batching (scan pipeline; defined after the walkers) */
static int receipt_leaf(Scan *s, Parser *p, int64_t index, void *ctx);
static int receipt_batch_run(Scan *s, Parser *p, const int64_t *indices,
                             int n_idx, void *ctx);

static int walk_node(Scan *s, const uint8_t *cid, Py_ssize_t clen,
                     Parser *inline_node, int bit_width, int height,
                     int64_t base, leaf_fn fn, void *ctx) {
  BlockRef block = {0};
  Parser local;
  Parser *p;
  if (inline_node) {
    p = inline_node;
  } else {
    int st = get_block(s, cid, clen, &block);
    if (st < 0) return -1;
    if (st == 0) return 0; /* pruned: block absent under skip_missing */
    local.data = block.data;
    local.len = block.len;
    local.pos = 0;
    p = &local;
  }

  int rc = -1;
  uint64_t parts;
  if (rd_array(p, &parts) < 0 || parts != 3) {
    /* walk_err keeps the first error; NEVER touch PyErr here — this runs
     * on GIL-free worker threads with no Python thread state */
    walk_err(E_VALUE, "malformed AMT node");
    goto out;
  }
  const uint8_t *bmap;
  Py_ssize_t bmap_len;
  if (rd_bytes(p, &bmap, &bmap_len) < 0) goto out;

  int width = 1 << bit_width;
  if (bmap_len * 8 < width) {
    walk_err(E_VALUE, "AMT bitmap too short");
    goto out;
  }

  /* links array: collect spans */
  uint64_t n_links;
  if (rd_array(p, &n_links) < 0) goto out;
  if (n_links > (uint64_t)width) {
    walk_err(E_VALUE, "too many AMT links");
    goto out;
  }
  const uint8_t *link_ptr[256];
  Py_ssize_t link_len[256];
  for (uint64_t i = 0; i < n_links; i++) {
    int ok;
    if (rd_cid_or_null(p, &link_ptr[i], &link_len[i], &ok) < 0) goto out;
    if (!ok) {
      walk_err(E_VALUE, "null AMT link");
      goto out;
    }
  }

  uint64_t n_values;
  if (rd_array(p, &n_values) < 0) goto out;

  /* pop-count ascending slots; links/values appear in set-bit order */
  int64_t span = 1;
  for (int h = 0; h < height; h++) span *= width;

  /* Receipts-leaf pipeline: on the snapshot path (no touch recording —
   * the scan never records), collect the leaf's value slots first, then
   * run the 3-pass parse/prefetch/walk batch. Error ORDER is preserved:
   * a structural bitmap/values error at slot k is DEFERRED until the
   * prefix's receipts (and their events AMTs) processed cleanly — exactly
   * when the sequential walk would have reached it. */
  if (height == 0 && fn == receipt_leaf && s->cmap && !s->touch_pool) {
    int64_t slots_buf[256];
    int n_slots = 0;
    const char *deferred = NULL;
    for (int byte_i = 0; byte_i * 8 < width && !deferred; byte_i++) {
      unsigned bits = bmap[byte_i];
      if (width - byte_i * 8 < 8) bits &= (1u << (width - byte_i * 8)) - 1;
      while (bits) {
        int slot = byte_i * 8 + __builtin_ctz(bits);
        bits &= bits - 1;
        if ((uint64_t)n_slots >= n_values) {
          deferred = "AMT leaf bitmap/values mismatch";
          break;
        }
        slots_buf[n_slots++] = base + slot;
      }
    }
    if (!deferred && (uint64_t)n_slots != n_values)
      deferred = "AMT leaf value count mismatch";
    if (receipt_batch_run(s, p, slots_buf, n_slots, ctx) < 0) goto out;
    if (deferred) {
      walk_err(E_VALUE, deferred);
      goto out;
    }
    rc = 0;
    goto out;
  }

  /* iterate SET bits via ctz instead of testing all `width` slots — same
   * ascending slot order and pos counting; bits at positions >= width are
   * ignored exactly as the slot-bounded loop ignored them */
  int pos = 0;
  uint64_t used_values = 0;
  for (int byte_i = 0; byte_i * 8 < width; byte_i++) {
    unsigned bits = bmap[byte_i];
    if (width - byte_i * 8 < 8) bits &= (1u << (width - byte_i * 8)) - 1;
    while (bits) {
      int slot = byte_i * 8 + __builtin_ctz(bits);
      bits &= bits - 1;
      if (height == 0) {
        if ((uint64_t)pos >= n_values) {
          walk_err(E_VALUE, "AMT leaf bitmap/values mismatch");
          goto out;
        }
        if (fn(s, p, base + slot, ctx) < 0) goto out;
        used_values++;
      } else {
        if ((uint64_t)pos >= n_links) {
          walk_err(E_VALUE, "AMT node bitmap/links mismatch");
          goto out;
        }
        if (walk_node(s, link_ptr[pos], link_len[pos], NULL, bit_width,
                      height - 1, base + slot * span, fn, ctx) < 0)
          goto out;
      }
      pos++;
    }
  }
  if (height == 0 && used_values != n_values) {
    walk_err(E_VALUE, "AMT leaf value count mismatch");
    goto out;
  }
  rc = 0;
out:
  block_release(&block);
  return rc;
}

/* Parse an AMT root body: [h,c,node] (v0, bw=3) or [bw,h,c,node] (v3).
 * Leaves the parser positioned at the inline node. */
static int parse_amt_root(Parser *p, int expected_version, int *bit_width_out,
                          int *height_out) {
  uint64_t arity;
  if (rd_array(p, &arity) < 0) return -1;
  int bit_width, height;
  uint64_t tmp;
  if (arity == 4) {
    if (expected_version != 3) {
      walk_err(E_VALUE, "expected AMT v0, found v3");
      return -1;
    }
    if (rd_uint(p, &tmp) < 0) return -1;
    /* range-check the raw u64 BEFORE narrowing: a forged bit-width of
     * e.g. 2^32+3 must not wrap into the valid range. */
    if (tmp < 1 || tmp > 8) {
      walk_err(E_VALUE, "invalid AMT bit width");
      return -1;
    }
    bit_width = (int)tmp;
  } else if (arity == 3) {
    if (expected_version != 0) {
      walk_err(E_VALUE, "expected AMT v3, found v0");
      return -1;
    }
    bit_width = 3;
  } else {
    walk_err(E_VALUE, "unrecognized AMT root arity");
    return -1;
  }
  if (rd_uint(p, &tmp) < 0) return -1; /* height */
  /* range-check the raw u64 BEFORE narrowing: a forged height of 2^32
   * would truncate to 0 and walk as a leaf (amt.py raises here too). */
  if (tmp > 64) {
    walk_err(E_VALUE, "invalid AMT height");
    return -1;
  }
  height = (int)tmp;
  /* span = width^height and every index stay below 2^62: forged roots with
   * huge heights must fail cleanly, not overflow int64 (UB). */
  if ((int64_t)bit_width * (height + 1) > 62) {
    walk_err(E_VALUE, "AMT too deep for native scanner");
    return -1;
  }
  if (rd_uint(p, &tmp) < 0) return -1; /* count (unused) */
  *bit_width_out = bit_width;
  *height_out = height;
  return 0;
}

/* Walk an AMT root block.  expected_version: 0 (root [h,c,node], bw=3) or
 * 3 (root [bw,h,c,node]). */
static int walk_amt_root(Scan *s, const uint8_t *cid, Py_ssize_t clen,
                         int expected_version, leaf_fn fn, void *ctx) {
  BlockRef block = {0};
  int st = get_block(s, cid, clen, &block);
  if (st < 0) return -1;
  if (st == 0) return 0; /* pruned root */
  Parser p = {block.data, block.len, 0};
  int rc = -1;
  int bit_width, height;
  if (parse_amt_root(&p, expected_version, &bit_width, &height) < 0) goto out;
  rc = walk_node(s, NULL, 0, &p, bit_width, height, 0, fn, ctx);
out:
  block_release(&block);
  return rc;
}

/* Targeted AMT get: walk exactly one root-to-leaf path for ``index``
 * (ipld/amt.py AMT.get parity, incl. partial-path touches when the index
 * turns out absent).  ``node`` must be positioned at the root's inline
 * node.  Invokes fn at the value when present. */
static int amt_get_path(Scan *s, Parser node, int bit_width, int height,
                        int64_t index, leaf_fn fn, void *ctx) {
  int width = 1 << bit_width;
  if (index < 0) {
    walk_err(E_VALUE, "negative AMT index");
    return -1;
  }
  /* index >= width^(height+1) -> absent (parse_amt_root bounded the span) */
  if (index >> ((int64_t)bit_width * (height + 1)) != 0) return 0;

  BlockRef block = {0}; /* current non-root node's block, if any */
  int rc = -1;
  for (int h = height; h >= 0; h--) {
    uint64_t parts;
    if (rd_array(&node, &parts) < 0 || parts != 3) {
      walk_err(E_VALUE, "malformed AMT node");
      goto out;
    }
    const uint8_t *bmap;
    Py_ssize_t bmap_len;
    if (rd_bytes(&node, &bmap, &bmap_len) < 0) goto out;
    if (bmap_len * 8 < width) {
      walk_err(E_VALUE, "AMT bitmap too short");
      goto out;
    }
    int slot = (int)((index >> ((int64_t)bit_width * h)) & (width - 1));
    if (!((bmap[slot >> 3] >> (slot & 7)) & 1)) {
      rc = 0; /* absent */
      goto out;
    }
    int pos = 0; /* popcount of set bits below slot */
    for (int i = 0; i < (slot >> 3); i++) pos += __builtin_popcount(bmap[i]);
    pos += __builtin_popcount(bmap[slot >> 3] & ((1u << (slot & 7)) - 1u));

    uint64_t n_links;
    if (rd_array(&node, &n_links) < 0) goto out;
    if (h > 0) {
      if ((uint64_t)pos >= n_links) {
        walk_err(E_VALUE, "AMT node bitmap/links mismatch");
        goto out;
      }
      const uint8_t *child_cid = NULL;
      Py_ssize_t child_len = 0;
      for (int i = 0; i <= pos; i++) {
        int ok;
        if (rd_cid_or_null(&node, &child_cid, &child_len, &ok) < 0) goto out;
        if (!ok) {
          walk_err(E_VALUE, "null AMT link");
          goto out;
        }
      }
      BlockRef next = {0};
      int st = get_block(s, child_cid, child_len, &next);
      if (st < 0) goto out;
      if (st == 0) { rc = 0; goto out; } /* pruned under skip_missing */
      block_release(&block);
      block = next;
      node.data = block.data;
      node.len = block.len;
      node.pos = 0;
    } else {
      for (uint64_t i = 0; i < n_links; i++)
        if (skip_item(&node) < 0) goto out;
      uint64_t n_values;
      if (rd_array(&node, &n_values) < 0) goto out;
      if ((uint64_t)pos >= n_values) {
        walk_err(E_VALUE, "AMT leaf bitmap/values mismatch");
        goto out;
      }
      for (int i = 0; i < pos; i++)
        if (skip_item(&node) < 0) goto out;
      if (fn(s, &node, index, ctx) < 0) goto out;
      rc = 0;
    }
  }
out:
  block_release(&block);
  return rc;
}

/* ---------------- receipts -> events plumbing ---------------- */

typedef struct {
  int32_t pair_id;
  int32_t rcpt_idx;
  int32_t next_event_pos; /* running event index within one events AMT */
} EvCtx;

static int event_leaf(Scan *s, Parser *p, int64_t index, void *ctx) {
  EvCtx *c = (EvCtx *)ctx;
  if (index > INT32_MAX) {
    walk_err(E_VALUE, "event index exceeds int32 range");
    return -1;
  }
  return emit_event(s, p, c->pair_id, c->rcpt_idx, (int32_t)index);
}

typedef struct {
  int32_t pair_id;
} RcptCtx;

/* parse one receipt tuple; on success *has_ev / *ev_cid / *ev_len describe its
 * events root (absent for 3-tuples and null links) */
static int receipt_parse(Parser *p, const uint8_t **ev_cid, Py_ssize_t *ev_len,
                         int *has_ev) {
  *has_ev = 0;
  uint64_t arity;
  if (rd_array(p, &arity) < 0) return -1;
  if (arity != 3 && arity != 4) {
    walk_err(E_VALUE, "receipt must be a 3/4-tuple");
    return -1;
  }
  if (skip_item(p) < 0) return -1; /* exit_code */
  if (skip_item(p) < 0) return -1; /* return_data */
  if (skip_item(p) < 0) return -1; /* gas_used */
  if (arity == 3) return 0;        /* no events root */
  int ok;
  if (rd_cid_or_null(p, ev_cid, ev_len, &ok) < 0) return -1;
  *has_ev = ok; /* null events root: skip (scan_receipt_events parity) */
  return 0;
}

static int receipt_leaf(Scan *s, Parser *p, int64_t index, void *ctx) {
  RcptCtx *c = (RcptCtx *)ctx;
  const uint8_t *ev_cid;
  Py_ssize_t ev_len;
  int has_ev;
  if (receipt_parse(p, &ev_cid, &ev_len, &has_ev) < 0) return -1;
  if (!has_ev) return 0;
  if (index > INT32_MAX) {
    walk_err(E_VALUE, "receipt index exceeds int32 range");
    return -1;
  }
  s->n_receipts++;
  EvCtx ec = {c->pair_id, (int32_t)index, 0};
  return walk_amt_root(s, ev_cid, ev_len, 3, event_leaf, &ec);
}

/* The scan's hottest memory pattern is one dependent-load chain per
 * receipt: cmap slot -> block bytes -> AMT root parse. Per LEAF (up to
 * `width` receipts) the batch splits it into passes so the loads overlap:
 * pass 1 parses every receipt and prefetches its events root's cmap slot;
 * pass 2 resolves the slots and prefetches the block bytes; pass 3 walks
 * each events AMT in index order. Semantics are the sequential loop's
 * exactly — a parse error at receipt k is DEFERRED until receipts < k
 * (and their events AMTs) completed, which is when the sequential walk
 * would have hit it; cmap misses re-enter the ordinary get_block path. */
static int receipt_batch_run(Scan *s, Parser *p, const int64_t *indices,
                             int n_idx, void *ctx) {
  RcptCtx *c = (RcptCtx *)ctx;
  const uint8_t *ev_cid[256];
  Py_ssize_t ev_len[256];
  int64_t ev_index[256];
  const CEntry *ents[256];
  int n_ev = 0;
  /* a pass-1 parse error must not land in the first-wins t_err yet: the
   * sequential walk runs EARLIER receipts' events AMTs before reaching the
   * malformed receipt, so any error THEY raise (missing block, non-bytes
   * value, OOM) takes precedence. Stash the parse error, clear t_err, and
   * restore it only if the prefix's walks recorded nothing. */
  WalkErr deferred_err;
  deferred_err.kind = E_NONE;
  int parse_failed = 0;
  for (int i = 0; i < n_idx; i++) {
    const uint8_t *cid = NULL;
    Py_ssize_t clen = 0;
    int has = 0;
    if (receipt_parse(p, &cid, &clen, &has) < 0) {
      deferred_err = t_err;
      t_err.kind = E_NONE;
      parse_failed = 1;
      break;
    }
    if (!has) continue;
    if (indices[i] > INT32_MAX) {
      deferred_err.kind = E_VALUE;
      strcpy(deferred_err.msg, "receipt index exceeds int32 range");
      parse_failed = 1;
      break;
    }
    ev_cid[n_ev] = cid;
    ev_len[n_ev] = clen;
    ev_index[n_ev] = indices[i];
    __builtin_prefetch(&s->cmap->slots[cmap_hash(cid, clen) & s->cmap->mask]);
    n_ev++;
  }
  for (int k = 0; k < n_ev; k++) {
    ents[k] = cmap_get(s->cmap, ev_cid[k], ev_len[k]);
    if (ents[k] && ents[k]->vlen >= 0) {
      __builtin_prefetch(ents[k]->val);
      if (ents[k]->vlen > 64) __builtin_prefetch(ents[k]->val + 64);
      if (ents[k]->vlen > 128) __builtin_prefetch(ents[k]->val + 128);
    }
  }
  for (int k = 0; k < n_ev; k++) {
    s->n_receipts++;
    EvCtx ec = {c->pair_id, (int32_t)ev_index[k], 0};
    const CEntry *e = ents[k];
    if (!e) {
      /* miss: the ordinary root walk redoes get_block, which falls
       * through to the live dict / fallback exactly as unbatched */
      if (walk_amt_root(s, ev_cid[k], ev_len[k], 3, event_leaf, &ec) < 0)
        return -1;
      continue;
    }
    if (e->vlen == -2) return walk_err(E_TYPE, "block map values must be bytes");
    if (s->validate && validate_block(e->val, e->vlen) < 0) return -1;
    Parser rp = {e->val, e->vlen, 0};
    int bw, h;
    if (parse_amt_root(&rp, 3, &bw, &h) < 0) return -1;
    if (walk_node(s, NULL, 0, &rp, bw, h, 0, event_leaf, &ec) < 0) return -1;
  }
  if (parse_failed) {
    /* pass 3 completed without error to reach here, so nothing newer can
     * be pending — and NO PyErr calls on this path: it runs on GIL-free
     * worker threads with no Python thread state */
    if (t_err.kind == E_NONE) t_err = deferred_err;
    return -1;
  }
  return 0;
}

/* ---------------- module entry ---------------- */

static PyObject *make_array_bytes(Vec *v) {
  return PyBytes_FromStringAndSize((const char *)(v->buf ? v->buf : (uint8_t *)""),
                                   (Py_ssize_t)v->len);
}

static void scan_free(Scan *s) {
  vec_free(&s->topics); vec_free(&s->fp); vec_free(&s->n_topics);
  vec_free(&s->emitters);
  vec_free(&s->valid); vec_free(&s->pair_ids); vec_free(&s->exec_idx);
  vec_free(&s->event_idx); vec_free(&s->topics_pool); vec_free(&s->data_pool);
  vec_free(&s->topics_off); vec_free(&s->data_off); vec_free(&s->data_len);
  vec_free(&s->hit_pairs); vec_free(&s->hit_exec);
}

/* scan a contiguous range of roots into one Scan; roots are pre-extracted
 * (ptr, len) pairs so the worker never touches Python objects */
typedef struct {
  Scan s;                 /* thread-private outputs */
  const uint8_t **cids;   /* all root cid pointers */
  const Py_ssize_t *lens; /* all root cid lengths */
  Py_ssize_t lo, hi;      /* this worker's root range */
  WalkErr err;            /* copied from t_err at thread exit */
} ScanJob;

static int scan_roots_range(Scan *s, const uint8_t **cids,
                            const Py_ssize_t *lens, Py_ssize_t lo,
                            Py_ssize_t hi) {
  for (Py_ssize_t i = lo; i < hi; i++) {
    RcptCtx rc = {(int32_t)i};
    if (walk_amt_root(s, cids[i], lens[i], 0, receipt_leaf, &rc) < 0)
      return -1;
  }
  return 0;
}

static void *scan_job_run(void *arg) {
  ScanJob *job = (ScanJob *)arg;
  t_err.kind = E_NONE;
  if (scan_roots_range(&job->s, job->cids, job->lens, job->lo, job->hi) < 0)
    job->err = t_err;
  return NULL;
}

/* merge `src` onto the tail of `dst`, rebasing the payload-offset columns
 * by dst's pool sizes (all other columns are position-independent) */
static int scan_merge(Scan *dst, Scan *src) {
  if (src->want_payload && src->n_events) {
    if (pool_off_ok(dst->topics_pool.len + src->topics_pool.len, UINT32_MAX) < 0 ||
        pool_off_ok(dst->data_pool.len + src->data_pool.len, UINT32_MAX) < 0)
      return -1;
    uint32_t tbase = (uint32_t)dst->topics_pool.len;
    uint32_t dbase = (uint32_t)dst->data_pool.len;
    uint32_t *toff = (uint32_t *)src->topics_off.buf;
    uint32_t *doff = (uint32_t *)src->data_off.buf;
    for (int64_t i = 0; i < src->n_events; i++) {
      toff[i] += tbase;
      doff[i] += dbase;
    }
  }
  if (vec_push(&dst->topics, src->topics.buf, src->topics.len) < 0 ||
      vec_push(&dst->fp, src->fp.buf, src->fp.len) < 0 ||
      vec_push(&dst->n_topics, src->n_topics.buf, src->n_topics.len) < 0 ||
      vec_push(&dst->emitters, src->emitters.buf, src->emitters.len) < 0 ||
      vec_push(&dst->valid, src->valid.buf, src->valid.len) < 0 ||
      vec_push(&dst->pair_ids, src->pair_ids.buf, src->pair_ids.len) < 0 ||
      vec_push(&dst->exec_idx, src->exec_idx.buf, src->exec_idx.len) < 0 ||
      vec_push(&dst->event_idx, src->event_idx.buf, src->event_idx.len) < 0 ||
      vec_push(&dst->topics_pool, src->topics_pool.buf, src->topics_pool.len) < 0 ||
      vec_push(&dst->data_pool, src->data_pool.buf, src->data_pool.len) < 0 ||
      vec_push(&dst->topics_off, src->topics_off.buf, src->topics_off.len) < 0 ||
      vec_push(&dst->data_off, src->data_off.buf, src->data_off.len) < 0 ||
      vec_push(&dst->data_len, src->data_len.buf, src->data_len.len) < 0)
    return -1;
  /* fused-match hits: pair ids are global root positions, so chunk
   * concatenation in job order preserves the sequential emission order */
  if (vec_push(&dst->hit_pairs, src->hit_pairs.buf, src->hit_pairs.len) < 0 ||
      vec_push(&dst->hit_exec, src->hit_exec.buf, src->hit_exec.len) < 0)
    return -1;
  dst->n_events += src->n_events;
  dst->n_receipts += src->n_receipts;
  return 0;
}

static int scan_threads_default(void) {
  const char *env = getenv("IPC_SCAN_THREADS");
  if (env && env[0]) {
    int v = atoi(env);
    return v < 1 ? 1 : (v > 64 ? 64 : v);
  }
  long cores = sysconf(_SC_NPROCESSORS_ONLN);
  int t = (int)(cores > 0 ? cores : 1);
  return t > 8 ? 8 : t;
}

/* Fan the roots out over `threads` pthread jobs probing `map` (a complete
 * snapshot — jobs never touch the Python dict), then merge chunk outputs
 * into `s` in job order (first error in root order wins, identical to the
 * sequential walk). Shared by the transient-build and provided-snapshot
 * arms of py_scan_events_batch. Returns 0, or -1 with an exception set. */
static int scan_fanout(Scan *s, const uint8_t **cids, const Py_ssize_t *lens,
                       Py_ssize_t n_roots, int threads, const CMap *map) {
  ScanJob *jobs = calloc(threads, sizeof(ScanJob));
  pthread_t *tids = malloc(sizeof(pthread_t) * threads);
  if (!jobs || !tids) {
    free(jobs);
    free(tids);
    PyErr_NoMemory();
    return -1;
  }
  Py_ssize_t chunk = (n_roots + threads - 1) / threads;
  int started = 0;
  for (int t = 0; t < threads; t++) {
    /* s's output vecs are still empty here, so a struct copy hands each
     * worker the config (skip_missing/want_payload) with zeroed outputs */
    jobs[t].s = *s;
    jobs[t].s.blocks = NULL;
    jobs[t].s.fallback = NULL;
    jobs[t].s.cmap = map;
    jobs[t].cids = cids;
    jobs[t].lens = lens;
    jobs[t].lo = t * chunk;
    jobs[t].hi = (t + 1) * chunk < n_roots ? (t + 1) * chunk : n_roots;
    if (jobs[t].lo >= jobs[t].hi) break;
    started++;
  }
  Py_BEGIN_ALLOW_THREADS;
  for (int t = 0; t < started; t++)
    if (pthread_create(&tids[t], NULL, scan_job_run, &jobs[t]) != 0) {
      /* run inline if a thread can't spawn — correctness over speed */
      scan_job_run(&jobs[t]);
      tids[t] = 0;
    }
  for (int t = 0; t < started; t++)
    if (tids[t]) pthread_join(tids[t], NULL);
  Py_END_ALLOW_THREADS;

  int rc = 0;
  int err_at = -1;
  for (int t = 0; t < started; t++)
    if (jobs[t].err.kind != E_NONE && err_at < 0) err_at = t;
  if (err_at >= 0) {
    raise_err(&jobs[err_at].err);
    rc = -1;
  } else {
    int merge_rc = 0;
    for (int t = 0; t < started && merge_rc == 0; t++)
      merge_rc = scan_merge(s, &jobs[t].s);
    if (merge_rc < 0) {
      raise_walk_err();
      rc = -1;
    }
  }
  for (int t = 0; t < started; t++) scan_free(&jobs[t].s);
  free(jobs);
  free(tids);
  return rc;
}

static PyObject *scan_result_dict(Scan *s) {
  if (s->match_mode)
    return Py_BuildValue(
        "{s:N,s:N,s:L,s:L}",
        "hit_pairs", make_array_bytes(&s->hit_pairs),
        "hit_exec", make_array_bytes(&s->hit_exec),
        "n_events", (long long)s->n_events,
        "n_receipts", (long long)s->n_receipts);
  return Py_BuildValue(
      "{s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:L,s:L}",
      "topics", make_array_bytes(&s->topics),
      "fp", make_array_bytes(&s->fp),
      "n_topics", make_array_bytes(&s->n_topics),
      "emitters", make_array_bytes(&s->emitters),
      "valid", make_array_bytes(&s->valid),
      "pair_ids", make_array_bytes(&s->pair_ids),
      "exec_idx", make_array_bytes(&s->exec_idx),
      "event_idx", make_array_bytes(&s->event_idx),
      "topics_pool", make_array_bytes(&s->topics_pool),
      "data_pool", make_array_bytes(&s->data_pool),
      "topics_off", make_array_bytes(&s->topics_off),
      "data_off", make_array_bytes(&s->data_off),
      "data_len", make_array_bytes(&s->data_len),
      "n_events", (long long)s->n_events,
      "n_receipts", (long long)s->n_receipts);
}

static PyObject *py_scan_events_batch(PyObject *self, PyObject *args,
                                      PyObject *kwargs) {
  (void)self;
  PyObject *blocks, *roots, *fallback = Py_None;
  PyObject *match_fp_obj = Py_None, *match_actor_obj = Py_None;
  PyObject *snap_obj = Py_None, *threads_obj = Py_None;
  int skip_missing = 0, want_payload = 0, validate_blocks = 0;
  static char *kwlist[] = {"blocks", "roots", "fallback", "skip_missing",
                           "want_payload", "match_fp", "match_actor",
                           "validate_blocks", "snapshot", "threads", NULL};
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "O!O|OppOOpOO", kwlist,
                                   &PyDict_Type, &blocks, &roots, &fallback,
                                   &skip_missing, &want_payload,
                                   &match_fp_obj, &match_actor_obj,
                                   &validate_blocks, &snap_obj, &threads_obj))
    return NULL;
  /* threads=None keeps the env/core default; an explicit count is the
   * caller's share of a process-wide budget (utils/threads.py) so that
   * N scan workers x per-call fan-out stops oversubscribing the host */
  int threads_override = 0;
  if (threads_obj != Py_None) {
    long v = PyLong_AsLong(threads_obj);
    if (v == -1 && PyErr_Occurred()) return NULL;
    threads_override = v < 1 ? 1 : (v > 64 ? 64 : (int)v);
  }
  const CMap *snap_map = NULL;
  int snap_complete = 0;
  if (snapshot_resolve(snap_obj, blocks, &snap_map, &snap_complete) < 0)
    return NULL;
  PyObject *seq = PySequence_Fast(roots, "roots must be a sequence of cid bytes");
  if (!seq) return NULL;

  t_err.kind = E_NONE;
  Scan s;
  memset(&s, 0, sizeof(s));
  s.blocks = blocks;
  s.fallback = fallback;
  s.skip_missing = skip_missing;
  s.want_payload = want_payload;
  s.validate = validate_blocks;
  if (match_fp_obj != Py_None) {
    if (want_payload) {
      PyErr_SetString(PyExc_ValueError,
                      "match_fp excludes want_payload (fused match emits no "
                      "per-event columns)");
      Py_DECREF(seq);
      return NULL;
    }
    s.match_mode = 1;
    s.match_fp = PyLong_AsUnsignedLongLong(match_fp_obj);
    if (PyErr_Occurred()) {
      Py_DECREF(seq);
      return NULL;
    }
  }
  if (match_actor_obj != Py_None) {
    if (!s.match_mode) {
      PyErr_SetString(PyExc_ValueError,
                      "match_actor requires match_fp (the actor filter is "
                      "part of the fused match predicate)");
      Py_DECREF(seq);
      return NULL;
    }
    s.match_has_actor = 1;
    s.match_actor = PyLong_AsUnsignedLongLong(match_actor_obj);
    if (PyErr_Occurred()) {
      Py_DECREF(seq);
      return NULL;
    }
  }

  Py_ssize_t n_roots = PySequence_Fast_GET_SIZE(seq);
  /* pre-extract root cid spans; validates types up front (same TypeError) */
  const uint8_t **cids = malloc(sizeof(*cids) * (n_roots ? n_roots : 1));
  Py_ssize_t *lens = malloc(sizeof(*lens) * (n_roots ? n_roots : 1));
  if (!cids || !lens) {
    PyErr_NoMemory();
    goto fail;
  }
  for (Py_ssize_t i = 0; i < n_roots; i++) {
    PyObject *root = PySequence_Fast_GET_ITEM(seq, i);
    if (!PyBytes_Check(root)) {
      PyErr_SetString(PyExc_TypeError, "roots must be bytes (raw CID bytes)");
      goto fail;
    }
    cids[i] = (const uint8_t *)PyBytes_AS_STRING(root);
    lens[i] = PyBytes_GET_SIZE(root);
  }

  /* Snapshot path: GIL-free walk over an open-addressing snapshot of the
   * dict, fanned out over pthreads in contiguous root chunks (chunk
   * concatenation preserves the sequential emission order exactly). Only
   * when every block can come from the dict (no fallback callable).
   *
   * Taken even at ONE thread: profiling showed the dict-backed sequential
   * walk spends ~85% of its time in CPython (a PyBytes key allocation +
   * PyDict probe per block fetch); the cmap probe is a plain memcmp hash
   * table, ~25% faster end-to-end on a single core before any
   * parallelism. */
  int threads = threads_override ? threads_override : scan_threads_default();
  const char *no_snap = getenv("IPC_SCAN_NO_SNAPSHOT"); /* test/debug knob:
      force the Python-dict sequential walk to keep a true differential
      reference for the snapshot path (disables provided snapshots too) */
  if (no_snap && no_snap[0] == '1') snap_map = NULL;
  /* cmap_build is O(|dict|); without parallelism it only pays when the
   * scan touches a meaningful fraction of the store (a range scan touches
   * ~25 blocks per root), so the SINGLE-THREAD arm keeps the per-probe
   * dict walk for a huge dict with a tiny scan. The multi-thread arm
   * always snapshots — it needs the GIL-free table regardless of ratio.
   * A PROVIDED persistent snapshot skips the build entirely: single-chunk
   * use is unconditional (misses fall through to the dict probe, so
   * staleness and fallback callables are safe); the threaded arm uses it
   * only when complete and fallback-free, else builds transient. */
  int snapshot_pays =
      n_roots >= 64 && PyDict_Size(blocks) / n_roots <= 256;
  int want_threads = threads > 1 && n_roots >= 2 * threads && n_roots >= 64 &&
                     (fallback == NULL || fallback == Py_None);
  if (snap_map && !(want_threads && !snap_complete)) {
    if (threads > (int)(n_roots / 32) && n_roots / 32 >= 2)
      threads = (int)(n_roots / 32);
    if (!want_threads || threads <= 1) {
      /* single chunk over the provided snapshot, GIL HELD — misses fall
       * through to the dict probe in get_block, so staleness and fallback
       * callables are both safe here */
      s.cmap = snap_map;
      int rc_scan = scan_roots_range(&s, cids, lens, 0, n_roots);
      s.cmap = NULL;
      if (rc_scan < 0) {
        raise_walk_err();
        goto fail;
      }
      goto done_scan;
    }
    if (scan_fanout(&s, cids, lens, n_roots, threads, snap_map) < 0)
      goto fail;
    goto done_scan;
  }
  if ((fallback == NULL || fallback == Py_None) &&
      (snapshot_pays || (threads > 1 && n_roots >= 2 * threads && n_roots >= 64))) {
    CMap cmap = {0};
    if (cmap_build(&cmap, blocks, 0) < 0) {
      raise_walk_err();
      goto fail;
    }
    if (threads > (int)(n_roots / 32) && n_roots / 32 >= 2)
      threads = (int)(n_roots / 32);
    if (threads <= 1) {
      /* single chunk: scan straight into `s` over the snapshot with the
       * GIL HELD — the snapshot's borrowed dict-internals pointers stay
       * safe against other Python threads mutating the store mid-scan,
       * and no job struct / merge copy is needed. The speedup on this
       * path is the memcmp cmap probe replacing a PyBytes-alloc +
       * PyDict probe per block fetch, not parallelism. */
      s.cmap = &cmap;
      int rc_scan = scan_roots_range(&s, cids, lens, 0, n_roots);
      s.cmap = NULL;
      cmap_free(&cmap);
      if (rc_scan < 0) {
        raise_walk_err();
        goto fail;
      }
      goto done_scan;
    }
    int fanout_rc = scan_fanout(&s, cids, lens, n_roots, threads, &cmap);
    cmap_free(&cmap);
    if (fanout_rc < 0) goto fail;
  } else {
    if (scan_roots_range(&s, cids, lens, 0, n_roots) < 0) {
      raise_walk_err();
      goto fail;
    }
  }

done_scan:;
  {
    PyObject *result = scan_result_dict(&s);
    free(cids);
    free(lens);
    Py_DECREF(seq);
    scan_free(&s);
    return result;
  }

fail:
  free(cids);
  free(lens);
  Py_DECREF(seq);
  scan_free(&s);
  return NULL;
}

/* ---------------- batched execution-order walker ----------------
 *
 * The other Phase-C / verify hot loop: per tipset pair, TxMeta (bls_root,
 * secp_root) -> both v0 message-CID AMTs in index order.  One call walks
 * MANY groups; per-group errors set a failed flag instead of raising, so a
 * malformed group degrades exactly like the scalar path's caught
 * KeyError/ValueError (proofs of that group -> False) without aborting the
 * batch.  Python-side glue: proofs/exec_order.py.
 */

typedef struct {
  Vec *pool;
  Vec *off;
  Vec *len;
  /* first-seen dedup across the group's blocks/AMTs (scalar parity:
   * events/utils.rs:76-90 keeps the first occurrence) — open-addressing
   * table of (off/len-array index + 1) slots, reset per group */
  uint32_t *seen;
  size_t seen_cap; /* power of two; 0 = dedup disabled */
  size_t seen_n;
  size_t group_first; /* index of this group's first entry in off/len */
} CidSink;

static int sink_seen_grow(CidSink *sink) {
  size_t cap = sink->seen_cap ? sink->seen_cap * 2 : 128;
  uint32_t *tbl = calloc(cap, sizeof(uint32_t));
  if (!tbl) return walk_err(E_MEM, "out of memory");
  const int32_t *offs = (const int32_t *)sink->off->buf;
  const int32_t *lens = (const int32_t *)sink->len->buf;
  size_t total = sink->len->len / 4;
  for (size_t k = sink->group_first; k < total; k++) {
    const uint8_t *d = sink->pool->buf + offs[k];
    size_t i = cmap_hash(d, lens[k]) & (cap - 1);
    while (tbl[i]) i = (i + 1) & (cap - 1);
    tbl[i] = (uint32_t)(k + 1);
  }
  free(sink->seen);
  sink->seen = tbl;
  sink->seen_cap = cap;
  return 0;
}

static int msg_leaf(Scan *s, Parser *p, int64_t index, void *ctx) {
  (void)s;
  (void)index;
  CidSink *sink = (CidSink *)ctx;
  const uint8_t *cid;
  Py_ssize_t clen;
  int ok;
  if (rd_cid_or_null(p, &cid, &clen, &ok) < 0) return -1;
  if (!ok) {
    walk_err(E_VALUE, "message list AMT must hold CIDs");
    return -1;
  }
  /* first-seen dedup: probe the group's seen set; duplicates emit nothing */
  if (sink->seen_n * 2 >= sink->seen_cap && sink_seen_grow(sink) < 0)
    return -1;
  const int32_t *offs = (const int32_t *)sink->off->buf;
  const int32_t *lens = (const int32_t *)sink->len->buf;
  size_t mask = sink->seen_cap - 1;
  size_t i = cmap_hash(cid, clen) & mask;
  while (sink->seen[i]) {
    size_t k = sink->seen[i] - 1;
    if (lens[k] == (int32_t)clen &&
        memcmp(sink->pool->buf + offs[k], cid, (size_t)clen) == 0)
      return 0; /* duplicate: first occurrence wins */
    i = (i + 1) & mask;
  }
  if (pool_off_ok(sink->pool->len, INT32_MAX) < 0) return -1;
  int32_t off = (int32_t)sink->pool->len;
  int32_t len = (int32_t)clen;
  if (vec_push(sink->off, &off, 4) < 0) return -1;
  if (vec_push(sink->len, &len, 4) < 0) return -1;
  if (vec_push(sink->pool, cid, (size_t)clen) < 0) return -1;
  sink->seen[i] = (uint32_t)(sink->len->len / 4); /* new index + 1 */
  sink->seen_n++;
  return 0;
}

/* canonical re-encoding of TxMeta [bls, secp]: 0x82 ++ tag42(cid) x2 */
static int txmeta_is_canonical(const uint8_t *raw, Py_ssize_t rlen,
                               const uint8_t *bls, Py_ssize_t bls_len,
                               const uint8_t *secp, Py_ssize_t secp_len) {
  uint8_t buf[512];
  size_t n = 0;
  if ((size_t)(bls_len + secp_len) + 16 > sizeof(buf)) return 0;
  buf[n++] = 0x82;
  const uint8_t *cids[2] = {bls, secp};
  Py_ssize_t lens[2] = {bls_len, secp_len};
  for (int i = 0; i < 2; i++) {
    buf[n++] = 0xd8;
    buf[n++] = 0x2a;
    Py_ssize_t blen = lens[i] + 1; /* identity multibase prefix */
    if (blen < 24) {
      buf[n++] = 0x40 | (uint8_t)blen;
    } else if (blen < 256) {
      buf[n++] = 0x58;
      buf[n++] = (uint8_t)blen;
    } else {
      buf[n++] = 0x59;
      buf[n++] = (uint8_t)(blen >> 8);
      buf[n++] = (uint8_t)blen;
    }
    buf[n++] = 0x00;
    memcpy(buf + n, cids[i], (size_t)lens[i]);
    n += (size_t)lens[i];
  }
  return (Py_ssize_t)n == rlen && memcmp(buf, raw, n) == 0;
}

static PyObject *py_collect_exec_orders(PyObject *self, PyObject *args,
                                        PyObject *kwargs) {
  (void)self;
  PyObject *blocks, *groups, *fallback = Py_None, *snap_obj = Py_None;
  int headers = 1, want_touched = 1, validate_blocks = 0;
  static char *kwlist[] = {"blocks", "groups", "fallback", "headers",
                           "want_touched", "validate_blocks", "snapshot", NULL};
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "O!O|OpppO", kwlist,
                                   &PyDict_Type, &blocks, &groups, &fallback,
                                   &headers, &want_touched, &validate_blocks,
                                   &snap_obj))
    return NULL;
  const CMap *snap_map = NULL;
  if (snapshot_resolve(snap_obj, blocks, &snap_map, NULL) < 0)
    return NULL;
  PyObject *gseq = PySequence_Fast(groups, "groups must be a sequence");
  if (!gseq) return NULL;
  Py_ssize_t n_groups = PySequence_Fast_GET_SIZE(gseq);

  t_err.kind = E_NONE;
  Scan s;
  memset(&s, 0, sizeof(s));
  s.blocks = blocks;
  s.fallback = fallback;
  s.validate = validate_blocks;
  s.cmap = snap_map; /* GIL held throughout: misses fall through to dict */

  Vec msg_pool = {0}, msg_off = {0}, msg_len = {0}, msg_goff = {0};
  Vec touch_pool = {0}, touch_off = {0}, touch_len = {0}, touch_goff = {0};
  Vec tx_pool = {0}, tx_off = {0}, tx_len = {0}, tx_goff = {0}, tx_canon = {0};
  Vec failed = {0};
  if (want_touched) { /* verify-side callers skip witness recording */
    s.touch_pool = &touch_pool;
    s.touch_off = &touch_off;
    s.touch_len = &touch_len;
  }
  CidSink sink = {&msg_pool, &msg_off, &msg_len, NULL, 0, 0, 0};

  int rc = -1;
  for (Py_ssize_t g = 0; g < n_groups; g++) {
    /* fresh first-seen set per group */
    sink.seen_n = 0;
    sink.group_first = msg_off.len / 4;
    if (sink.seen) memset(sink.seen, 0, sink.seen_cap * sizeof(uint32_t));
    /* group starts (for truncation on per-group failure) */
    size_t m_pool0 = msg_pool.len, m_off0 = msg_off.len, m_len0 = msg_len.len;
    size_t t_pool0 = touch_pool.len, t_off0 = touch_off.len, t_len0 = touch_len.len;
    size_t x_pool0 = tx_pool.len, x_off0 = tx_off.len, x_len0 = tx_len.len,
           x_canon0 = tx_canon.len;
    int32_t mcount = (int32_t)(msg_off.len / 4);
    int32_t tcount = (int32_t)(touch_off.len / 4);
    int32_t xcount = (int32_t)(tx_off.len / 4);
    if (vec_push(&msg_goff, &mcount, 4) < 0) goto out;
    if (vec_push(&touch_goff, &tcount, 4) < 0) goto out;
    if (vec_push(&tx_goff, &xcount, 4) < 0) goto out;

    /* overlap the NEXT group's first dependent loads (header/TxMeta probe
     * slots) with this group's walk — snapshot path only. Peek ONLY
     * list/tuple groups: PySequence_Fast on a one-shot iterator would
     * exhaust it before its real pass (lists/tuples convert
     * idempotently); other group types just skip the prefetch. */
    if (snap_map && g + 1 < n_groups) {
      PyObject *nxt = PySequence_Fast_GET_ITEM(gseq, g + 1);
      if (PyList_Check(nxt) || PyTuple_Check(nxt)) {
        Py_ssize_t nn = PySequence_Size(nxt);
        for (Py_ssize_t i = 0; i < nn; i++) {
          PyObject *o = PyList_Check(nxt) ? PyList_GET_ITEM(nxt, i)
                                          : PyTuple_GET_ITEM(nxt, i);
          if (PyBytes_Check(o))
            __builtin_prefetch(
                &snap_map->slots[cmap_hash((const uint8_t *)PyBytes_AS_STRING(o),
                                           PyBytes_GET_SIZE(o)) &
                                 snap_map->mask]);
        }
      }
    }

    PyObject *grp = PySequence_Fast(PySequence_Fast_GET_ITEM(gseq, g),
                                    "group must be a sequence of cid bytes");
    if (!grp) goto out;
    int ok = 1;
    Py_ssize_t n_cids = PySequence_Fast_GET_SIZE(grp);
    for (Py_ssize_t i = 0; ok && i < n_cids; i++) {
      PyObject *cid_obj = PySequence_Fast_GET_ITEM(grp, i);
      if (!PyBytes_Check(cid_obj)) {
        Py_DECREF(grp);
        PyErr_SetString(PyExc_TypeError, "group entries must be cid bytes");
        goto out;
      }
      const uint8_t *in_cid = (const uint8_t *)PyBytes_AS_STRING(cid_obj);
      Py_ssize_t in_len = PyBytes_GET_SIZE(cid_obj);
      const uint8_t *tx_cid = in_cid;
      Py_ssize_t tx_clen = in_len;
      BlockRef header_block = {0};
      Parser hp;
      if (headers) {
        /* header fetches are NOT part of the touched set (the scalar path
         * adds headers to the witness explicitly, outside the recorder) */
        Vec *save = s.touch_pool;
        s.touch_pool = NULL;
        int st = get_block(&s, in_cid, in_len, &header_block);
        s.touch_pool = save;
        if (st <= 0) { ok = 0; break; }
        hp.data = header_block.data;
        hp.len = header_block.len;
        hp.pos = 0;
        uint64_t arity;
        if (rd_array(&hp, &arity) < 0 || arity != 16) { ok = 0; }
        for (int f = 0; ok && f < 10; f++)
          if (skip_item(&hp) < 0) ok = 0; /* fields 0..9 */
        int have = 0;
        if (ok && rd_cid_or_null(&hp, &tx_cid, &tx_clen, &have) < 0) ok = 0;
        if (ok && !have) ok = 0; /* messages field must be a CID */
        if (!ok) { block_release(&header_block); break; }
      }
      if (pool_off_ok(tx_pool.len, INT32_MAX) < 0) {
        block_release(&header_block);
        Py_DECREF(grp);
        goto out;
      }
      int32_t xoff = (int32_t)tx_pool.len, xlen = (int32_t)tx_clen;
      if (vec_push(&tx_off, &xoff, 4) < 0 || vec_push(&tx_len, &xlen, 4) < 0 ||
          vec_push(&tx_pool, tx_cid, (size_t)tx_clen) < 0) {
        block_release(&header_block);
        Py_DECREF(grp);
        goto out;
      }
      BlockRef tx_block = {0};
      int st = get_block(&s, tx_cid, tx_clen, &tx_block);
      block_release(&header_block); /* tx_cid may point into it — done */
      if (st <= 0) { ok = 0; break; }
      Parser tp = {tx_block.data, tx_block.len, 0};
      uint64_t two;
      const uint8_t *bls, *secp;
      Py_ssize_t bls_len, secp_len;
      int have_b = 0, have_s = 0;
      if (rd_array(&tp, &two) < 0 || two != 2 ||
          rd_cid_or_null(&tp, &bls, &bls_len, &have_b) < 0 || !have_b ||
          rd_cid_or_null(&tp, &secp, &secp_len, &have_s) < 0 || !have_s ||
          tp.pos != tp.len /* trailing bytes: decode_txmeta rejects these */) {
        block_release(&tx_block);
        ok = 0;
        break;
      }
      uint8_t canon = (uint8_t)txmeta_is_canonical(
          tx_block.data, tx_block.len, bls, bls_len, secp, secp_len);
      if (vec_push(&tx_canon, &canon, 1) < 0) {
        block_release(&tx_block);
        Py_DECREF(grp);
        goto out;
      }
      if (walk_amt_root(&s, bls, bls_len, 0, msg_leaf, &sink) < 0 ||
          walk_amt_root(&s, secp, secp_len, 0, msg_leaf, &sink) < 0)
        ok = 0;
      block_release(&tx_block);
    }
    Py_DECREF(grp);
    uint8_t fail = !ok;
    if (!ok) {
      if (walk_err_degradable()) {
        walk_err_clear(); /* per-group degradation, like the scalar caught errors */
        msg_pool.len = m_pool0; msg_off.len = m_off0; msg_len.len = m_len0;
        touch_pool.len = t_pool0; touch_off.len = t_off0; touch_len.len = t_len0;
        tx_pool.len = x_pool0; tx_off.len = x_off0; tx_len.len = x_len0;
        tx_canon.len = x_canon0;
      } else {
        goto out; /* real errors (TypeError, MemoryError) propagate */
      }
    }
    if (vec_push(&failed, &fail, 1) < 0) goto out;
  }
  {
    int32_t mcount = (int32_t)(msg_off.len / 4);
    int32_t tcount = (int32_t)(touch_off.len / 4);
    int32_t xcount = (int32_t)(tx_off.len / 4);
    if (vec_push(&msg_goff, &mcount, 4) < 0) goto out;
    if (vec_push(&touch_goff, &tcount, 4) < 0) goto out;
    if (vec_push(&tx_goff, &xcount, 4) < 0) goto out;
  }
  rc = 0;
out:;
  if (rc != 0) raise_walk_err();
  PyObject *result = NULL;
  if (rc == 0) {
    result = Py_BuildValue(
        "{s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N}",
        "msg_pool", make_array_bytes(&msg_pool),
        "msg_off", make_array_bytes(&msg_off),
        "msg_len", make_array_bytes(&msg_len),
        "msg_goff", make_array_bytes(&msg_goff),
        "touch_pool", make_array_bytes(&touch_pool),
        "touch_off", make_array_bytes(&touch_off),
        "touch_len", make_array_bytes(&touch_len),
        "touch_goff", make_array_bytes(&touch_goff),
        "tx_pool", make_array_bytes(&tx_pool),
        "tx_off", make_array_bytes(&tx_off),
        "tx_len", make_array_bytes(&tx_len),
        "tx_goff", make_array_bytes(&tx_goff),
        "tx_canon", make_array_bytes(&tx_canon),
        "failed", make_array_bytes(&failed));
  }
  Py_DECREF(gseq);
  free(sink.seen);
  vec_free(&msg_pool); vec_free(&msg_off); vec_free(&msg_len); vec_free(&msg_goff);
  vec_free(&touch_pool); vec_free(&touch_off); vec_free(&touch_len);
  vec_free(&touch_goff);
  vec_free(&tx_pool); vec_free(&tx_off); vec_free(&tx_len); vec_free(&tx_goff);
  vec_free(&tx_canon); vec_free(&failed);
  return result;
}

/* ---------------- batched pass-2 recorder ----------------
 *
 * The remaining Phase-C hot leg: for each matching pair, walk the receipts
 * AMT path to each matching receipt index and the FULL events AMT beneath
 * it, recording every touched block CID (the witness) and emitting every
 * event in payload mode (claim construction becomes a numpy mask + array
 * slicing in Python — zero Python AMT walks).  Python-side glue:
 * proofs/scan_native.py record_receipt_paths.  Scalar-parity anchor:
 * proofs/event_generator.py record_matching_receipts (reference
 * src/proofs/events/generator.rs:241-301). */

typedef struct {
  size_t topics, fp, n_topics, emitters, valid, pair_ids, exec_idx, event_idx;
  size_t topics_pool, data_pool, topics_off, data_off, data_len;
  int64_t n_events, n_receipts;
} ScanMark;

static ScanMark scan_mark(const Scan *s) {
  ScanMark m = {s->topics.len, s->fp.len, s->n_topics.len, s->emitters.len,
                s->valid.len, s->pair_ids.len, s->exec_idx.len,
                s->event_idx.len, s->topics_pool.len, s->data_pool.len,
                s->topics_off.len, s->data_off.len, s->data_len.len,
                s->n_events, s->n_receipts};
  return m;
}

static void scan_rewind(Scan *s, const ScanMark *m) {
  s->topics.len = m->topics; s->fp.len = m->fp;
  s->n_topics.len = m->n_topics; s->emitters.len = m->emitters;
  s->valid.len = m->valid; s->pair_ids.len = m->pair_ids;
  s->exec_idx.len = m->exec_idx; s->event_idx.len = m->event_idx;
  s->topics_pool.len = m->topics_pool; s->data_pool.len = m->data_pool;
  s->topics_off.len = m->topics_off; s->data_off.len = m->data_off;
  s->data_len.len = m->data_len;
  s->n_events = m->n_events; s->n_receipts = m->n_receipts;
}

static PyObject *py_record_receipt_paths(PyObject *self, PyObject *args,
                                         PyObject *kwargs) {
  (void)self;
  PyObject *blocks, *roots, *wanted, *fallback = Py_None, *snap_obj = Py_None;
  static char *kwlist[] = {"blocks", "roots", "wanted", "fallback", "snapshot",
                           NULL};
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "O!OO|OO", kwlist,
                                   &PyDict_Type, &blocks, &roots, &wanted,
                                   &fallback, &snap_obj))
    return NULL;
  const CMap *snap_map = NULL;
  if (snapshot_resolve(snap_obj, blocks, &snap_map, NULL) < 0)
    return NULL;
  PyObject *rseq = PySequence_Fast(roots, "roots must be a sequence");
  if (!rseq) return NULL;
  PyObject *wseq = PySequence_Fast(wanted, "wanted must be a sequence");
  if (!wseq) {
    Py_DECREF(rseq);
    return NULL;
  }
  Py_ssize_t n_groups = PySequence_Fast_GET_SIZE(rseq);
  if (PySequence_Fast_GET_SIZE(wseq) != n_groups) {
    Py_DECREF(rseq);
    Py_DECREF(wseq);
    PyErr_SetString(PyExc_ValueError, "roots/wanted length mismatch");
    return NULL;
  }

  t_err.kind = E_NONE;
  Scan s;
  memset(&s, 0, sizeof(s));
  s.blocks = blocks;
  s.fallback = (fallback == Py_None) ? NULL : fallback;
  s.cmap = snap_map; /* GIL held throughout: misses fall through to dict */
  s.want_payload = 1;
  Vec touch_pool = {0}, touch_off = {0}, touch_len = {0}, touch_goff = {0};
  Vec failed = {0};
  s.touch_pool = &touch_pool;
  s.touch_off = &touch_off;
  s.touch_len = &touch_len;

  int rc = -1;
  for (Py_ssize_t g = 0; g < n_groups; g++) {
    ScanMark mark = scan_mark(&s);
    size_t t_pool0 = touch_pool.len, t_off0 = touch_off.len,
           t_len0 = touch_len.len;
    int32_t tcount = (int32_t)(touch_off.len / 4);
    if (vec_push(&touch_goff, &tcount, 4) < 0) goto out;

    PyObject *root = PySequence_Fast_GET_ITEM(rseq, g);
    if (!PyBytes_Check(root)) {
      PyErr_SetString(PyExc_TypeError, "roots must be bytes (raw CID bytes)");
      goto out;
    }
    /* overlap the next group's root probe with this group's walks */
    if (snap_map && g + 1 < n_groups) {
      PyObject *nr = PySequence_Fast_GET_ITEM(rseq, g + 1);
      if (PyBytes_Check(nr))
        __builtin_prefetch(
            &snap_map->slots[cmap_hash((const uint8_t *)PyBytes_AS_STRING(nr),
                                       PyBytes_GET_SIZE(nr)) &
                             snap_map->mask]);
    }
    int ok = 1;
    BlockRef root_block = {0};
    /* receipts-AMT root fetched ONCE per group (AMT.load parity) */
    int st = get_block(&s, (const uint8_t *)PyBytes_AS_STRING(root),
                       PyBytes_GET_SIZE(root), &root_block);
    if (st < 0) ok = 0;
    if (st == 0) { /* only reachable under skip_missing (not used here) */
      walk_err(E_KEY, "missing receipts root");
      ok = 0;
    }
    Parser rp = {0};
    int bit_width = 0, height = 0;
    if (ok) {
      rp.data = root_block.data;
      rp.len = root_block.len;
      rp.pos = 0;
      if (parse_amt_root(&rp, 0, &bit_width, &height) < 0) ok = 0;
    }
    if (ok) {
      PyObject *wl = PySequence_Fast(PySequence_Fast_GET_ITEM(wseq, g),
                                     "wanted group must be a sequence");
      if (!wl) {
        block_release(&root_block);
        goto out;
      }
      Py_ssize_t n_idx = PySequence_Fast_GET_SIZE(wl);
      RcptCtx rctx = {(int32_t)g};
      for (Py_ssize_t k = 0; ok && k < n_idx; k++) {
        long long idx = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(wl, k));
        if (idx == -1 && PyErr_Occurred()) {
          Py_DECREF(wl);
          block_release(&root_block);
          goto out; /* non-int wanted index: programming error, propagate */
        }
        Parser np = rp; /* re-walk from the root's inline node per index */
        if (amt_get_path(&s, np, bit_width, height, (int64_t)idx, receipt_leaf,
                         &rctx) < 0)
          ok = 0;
      }
      Py_DECREF(wl);
    }
    block_release(&root_block);
    uint8_t fail = !ok;
    if (!ok) {
      if (walk_err_degradable() && (PyErr_Occurred() || t_err.kind != E_NONE)) {
        walk_err_clear(); /* per-group degradation: caller redoes it scalar */
        scan_rewind(&s, &mark);
        touch_pool.len = t_pool0;
        touch_off.len = t_off0;
        touch_len.len = t_len0;
      } else {
        goto out; /* TypeError / MemoryError / OverflowError propagate */
      }
    }
    if (vec_push(&failed, &fail, 1) < 0) goto out;
  }
  {
    int32_t tcount = (int32_t)(touch_off.len / 4);
    if (vec_push(&touch_goff, &tcount, 4) < 0) goto out;
  }
  rc = 0;
out:;
  if (rc != 0) raise_walk_err();
  PyObject *result = NULL;
  if (rc == 0) {
    result = Py_BuildValue(
        "{s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:L,s:L,"
        "s:N,s:N,s:N,s:N,s:N}",
        "topics", make_array_bytes(&s.topics),
        "fp", make_array_bytes(&s.fp),
        "n_topics", make_array_bytes(&s.n_topics),
        "emitters", make_array_bytes(&s.emitters),
        "valid", make_array_bytes(&s.valid),
        "pair_ids", make_array_bytes(&s.pair_ids),
        "exec_idx", make_array_bytes(&s.exec_idx),
        "event_idx", make_array_bytes(&s.event_idx),
        "topics_pool", make_array_bytes(&s.topics_pool),
        "data_pool", make_array_bytes(&s.data_pool),
        "topics_off", make_array_bytes(&s.topics_off),
        "data_off", make_array_bytes(&s.data_off),
        "data_len", make_array_bytes(&s.data_len),
        "n_events", (long long)s.n_events,
        "n_receipts", (long long)s.n_receipts,
        "touch_pool", make_array_bytes(&touch_pool),
        "touch_off", make_array_bytes(&touch_off),
        "touch_len", make_array_bytes(&touch_len),
        "touch_goff", make_array_bytes(&touch_goff),
        "failed", make_array_bytes(&failed));
  }
  Py_DECREF(rseq);
  Py_DECREF(wseq);
  scan_free(&s);
  vec_free(&touch_pool); vec_free(&touch_off); vec_free(&touch_len);
  vec_free(&touch_goff); vec_free(&failed);
  return result;
}

/* split_pool(pool, off, len) -> list[bytes]
 *
 * off/len are little-endian i32 arrays (the pooled-output layout every
 * walker in this module emits). Materializes every pooled item as a bytes
 * object in one C call — the Python-level per-item slicing loop this
 * replaces was the dominant cost of unpacking large walks. */
/* ---------------- batched HAMT slot lookup ----------------
 *
 * The storage-side analog of the receipts scanner: one C call walks a
 * root→bucket HAMT path per (root, key) pair — the BASELINE config-3
 * shape (65k slots × 256 contract roots) and the range driver's
 * storage legs. Wire format per ipld/hamt.py: node = [bitfield(bytes),
 * [pointer, ...]]; pointer = tag-42 link | inline bucket [[k, v], ...];
 * key hash = sha256(key), bits consumed MSB-first, bit_width at a time.
 */

static const uint32_t sha_k[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

#define ROR32(x, n) (((x) >> (n)) | ((x) << (32 - (n))))

static void sha256_compress(uint32_t h[8], const uint8_t block[64]) {
  uint32_t w[64];
  for (int i = 0; i < 16; i++)
    w[i] = ((uint32_t)block[4 * i] << 24) | ((uint32_t)block[4 * i + 1] << 16) |
           ((uint32_t)block[4 * i + 2] << 8) | block[4 * i + 3];
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = ROR32(w[i - 15], 7) ^ ROR32(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = ROR32(w[i - 2], 17) ^ ROR32(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
           g = h[6], hh = h[7];
  for (int i = 0; i < 64; i++) {
    uint32_t s1 = ROR32(e, 6) ^ ROR32(e, 11) ^ ROR32(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = hh + s1 + ch + sha_k[i] + w[i];
    uint32_t s0 = ROR32(a, 2) ^ ROR32(a, 13) ^ ROR32(a, 22);
    uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = s0 + mj;
    hh = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

static void sha256_digest(const uint8_t *data, Py_ssize_t len, uint8_t out[32]) {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  Py_ssize_t off = 0;
  for (; off + 64 <= len; off += 64) sha256_compress(h, data + off);
  uint8_t block[64];
  Py_ssize_t rem = len - off;
  memcpy(block, data + off, (size_t)rem);
  block[rem++] = 0x80;
  if (rem > 56) {
    memset(block + rem, 0, (size_t)(64 - rem));
    sha256_compress(h, block);
    rem = 0;
  }
  memset(block + rem, 0, (size_t)(56 - rem));
  uint64_t bits = (uint64_t)len * 8;
  for (int i = 0; i < 8; i++) block[56 + i] = (uint8_t)(bits >> (56 - 8 * i));
  sha256_compress(h, block);
  for (int i = 0; i < 8; i++) {
    out[4 * i] = (uint8_t)(h[i] >> 24);
    out[4 * i + 1] = (uint8_t)(h[i] >> 16);
    out[4 * i + 2] = (uint8_t)(h[i] >> 8);
    out[4 * i + 3] = (uint8_t)h[i];
  }
}

/* bw bits of hash32 starting at bit position bw*depth, MSB-first */
static int hamt_hash_bits(const uint8_t hash[32], int depth, int bw,
                          uint32_t *out) {
  int start = bw * depth;
  if (start + bw > 256)
    return walk_err(E_VALUE, "HAMT max depth exceeded (hash bits exhausted)");
  uint32_t v = 0;
  for (int b = 0; b < bw; b++) {
    int bit = start + b;
    v = (v << 1) | (uint32_t)((hash[bit >> 3] >> (7 - (bit & 7))) & 1);
  }
  *out = v;
  return 0;
}

/* bit `i` (LSB order) of the big-endian minimal bitfield bytes */
static int bitfield_bit(const uint8_t *bf, Py_ssize_t bflen, uint32_t i) {
  Py_ssize_t byte = (Py_ssize_t)(i >> 3);
  if (byte >= bflen) return 0;
  return (bf[bflen - 1 - byte] >> (i & 7)) & 1;
}

/* walk one root→bucket path; on a hit pushes the VALUE's raw CBOR span
 * into val_pool (copied out before the node block is released). Returns
 * -1 error, 0 done (found flag set). */
static int hamt_get_one(Scan *s, const uint8_t *root, Py_ssize_t rlen,
                        const uint8_t *key, Py_ssize_t klen, int bw,
                        Vec *val_pool, int32_t *voff, int32_t *vlen,
                        uint8_t *found) {
  uint8_t hash[32];
  sha256_digest(key, klen, hash);
  uint8_t cid_buf[72];
  const uint8_t *cid = root;
  Py_ssize_t clen = rlen;
  int depth = 0;
  *found = 0;
  *voff = 0;
  *vlen = 0;
  for (;;) {
    BlockRef node = {0};
    int st = get_block(s, cid, clen, &node);
    if (st < 0) return -1;
    if (st == 0) return 0; /* pruned under skip_missing */
    Parser p = {node.data, node.len, 0};
    uint64_t parts;
    if (rd_array(&p, &parts) < 0 || parts != 2) {
      block_release(&node);
      return walk_err(E_VALUE, "malformed HAMT node");
    }
    const uint8_t *bf;
    Py_ssize_t bflen;
    if (rd_bytes(&p, &bf, &bflen) < 0) {
      block_release(&node);
      return walk_err(E_VALUE, "malformed HAMT node");
    }
    uint32_t idx;
    if (hamt_hash_bits(hash, depth, bw, &idx) < 0) {
      block_release(&node);
      return -1;
    }
    if (!bitfield_bit(bf, bflen, idx)) {
      block_release(&node);
      return 0; /* absent */
    }
    uint32_t pos = 0;
    /* popcount of set bits below idx (bitfield_bit semantics: bit i of the
     * big-endian minimal bytes, LSB order from the END of the buffer) */
    for (uint32_t j = 0; j < (idx >> 3); j++) {
      Py_ssize_t bpos = bflen - 1 - (Py_ssize_t)j;
      if (bpos >= 0) pos += (uint32_t)__builtin_popcount(bf[bpos]);
    }
    {
      Py_ssize_t bpos = bflen - 1 - (Py_ssize_t)(idx >> 3);
      if (bpos >= 0)
        pos += (uint32_t)__builtin_popcount(bf[bpos] & ((1u << (idx & 7)) - 1u));
    }
    uint64_t n_ptrs;
    if (rd_array(&p, &n_ptrs) < 0 || pos >= n_ptrs) {
      block_release(&node);
      return walk_err(E_VALUE, "malformed HAMT node");
    }
    for (uint32_t j = 0; j < pos; j++)
      if (skip_item(&p) < 0) {
        block_release(&node);
        return -1;
      }
    /* the selected pointer: link or bucket */
    const uint8_t *child;
    Py_ssize_t child_len;
    int is_cid;
    Parser peek = p;
    int pm;
    uint64_t pv;
    if (rd_head(&peek, &pm, &pv) < 0) {
      block_release(&node);
      return -1;
    }
    if (pm == 6) { /* tag (42) — a link */
      Parser q = p;
      if (rd_cid_or_null(&q, &child, &child_len, &is_cid) < 0 || !is_cid) {
        block_release(&node);
        return walk_err(E_VALUE, "malformed HAMT pointer");
      }
      if ((size_t)child_len > sizeof(cid_buf)) {
        block_release(&node);
        return walk_err(E_VALUE, "malformed HAMT pointer");
      }
      memcpy(cid_buf, child, (size_t)child_len);
      block_release(&node);
      cid = cid_buf;
      clen = child_len;
      depth++;
      continue;
    }
    if (pm != 4) {
      block_release(&node);
      return walk_err(E_VALUE, "malformed HAMT pointer");
    }
    /* bucket: [[key, value], ...] */
    uint64_t n_kv;
    if (rd_array(&p, &n_kv) < 0) {
      block_release(&node);
      return -1;
    }
    for (uint64_t k = 0; k < n_kv; k++) {
      uint64_t kv_fields;
      /* exactly 2 — the reference's KeyValuePair is a serde 2-tuple, and
       * the Python reader rejects != 2 identically */
      if (rd_array(&p, &kv_fields) < 0 || kv_fields != 2) {
        block_release(&node);
        return walk_err(E_VALUE, "malformed HAMT bucket");
      }
      /* key item: bytes compare when bytes, else skip (no match) */
      Parser kp = p;
      int km;
      uint64_t kv_len;
      int match = 0;
      if (rd_head(&kp, &km, &kv_len) < 0) {
        block_release(&node);
        return -1;
      }
      if (km == 2) {
        const uint8_t *kptr;
        Py_ssize_t kblen;
        if (rd_bytes(&p, &kptr, &kblen) < 0) {
          block_release(&node);
          return -1;
        }
        match = (kblen == klen && memcmp(kptr, key, (size_t)klen) == 0);
      } else {
        if (skip_item(&p) < 0) {
          block_release(&node);
          return -1;
        }
      }
      /* value item: span */
      Py_ssize_t vstart = p.pos;
      if (skip_item(&p) < 0) {
        block_release(&node);
        return -1;
      }
      if (match) {
        if (pool_off_ok(val_pool->len, INT32_MAX) < 0) {
          block_release(&node);
          return -1;
        }
        *voff = (int32_t)val_pool->len;
        *vlen = (int32_t)(p.pos - vstart);
        if (vec_push(val_pool, node.data + vstart, (size_t)(p.pos - vstart)) < 0) {
          block_release(&node);
          return -1;
        }
        *found = 1;
        block_release(&node);
        return 0;
      }
      for (uint64_t f = 2; f < kv_fields; f++)
        if (skip_item(&p) < 0) {
          block_release(&node);
          return -1;
        }
    }
    block_release(&node);
    return 0; /* bucket exhausted: absent */
  }
}

static PyObject *py_hamt_lookup_batch(PyObject *self, PyObject *args,
                                      PyObject *kwargs) {
  (void)self;
  PyObject *blocks, *roots, *owners, *keys, *fallback = Py_None;
  PyObject *snap_obj = Py_None;
  int bit_width = 5, skip_missing = 0, want_touched = 0, validate_blocks = 0;
  static char *kwlist[] = {"blocks",      "roots",        "owners",
                           "keys",        "bit_width",    "fallback",
                           "skip_missing", "want_touched", "validate_blocks",
                           "snapshot",    NULL};
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "O!OOO|iOpppO", kwlist,
                                   &PyDict_Type, &blocks, &roots, &owners,
                                   &keys, &bit_width, &fallback, &skip_missing,
                                   &want_touched, &validate_blocks, &snap_obj))
    return NULL;
  const CMap *hamt_snap_map = NULL;
  if (snapshot_resolve(snap_obj, blocks, &hamt_snap_map, NULL) < 0)
    return NULL;
  if (bit_width < 1 || bit_width > 8) {
    PyErr_SetString(PyExc_ValueError, "bit_width must be in [1, 8]");
    return NULL;
  }
  PyObject *rseq = PySequence_Fast(roots, "roots must be a sequence of cid bytes");
  if (!rseq) return NULL;
  PyObject *oseq = PySequence_Fast(owners, "owners must be a sequence of ints");
  if (!oseq) {
    Py_DECREF(rseq);
    return NULL;
  }
  PyObject *kseq = PySequence_Fast(keys, "keys must be a sequence of bytes");
  if (!kseq) {
    Py_DECREF(rseq);
    Py_DECREF(oseq);
    return NULL;
  }

  t_err.kind = E_NONE;
  Scan s;
  memset(&s, 0, sizeof(s));
  s.blocks = blocks;
  s.fallback = fallback;
  s.skip_missing = skip_missing;
  s.validate = validate_blocks;
  s.cmap = hamt_snap_map; /* GIL held: misses fall through to dict */

  Py_ssize_t n_roots = PySequence_Fast_GET_SIZE(rseq);
  Py_ssize_t n = PySequence_Fast_GET_SIZE(kseq);
  Vec found = {0}, val_pool = {0}, val_off = {0}, val_len = {0};
  Vec touch_pool = {0}, touch_off = {0}, touch_len = {0}, touch_goff = {0};
  if (want_touched) {
    /* per-item witness recording: every block the walk fetches, grouped
     * by item — the generation-side analog of the RecordingBlockstore */
    s.touch_pool = &touch_pool;
    s.touch_off = &touch_off;
    s.touch_len = &touch_len;
  }
  PyObject *result = NULL;
  if (PySequence_Fast_GET_SIZE(oseq) != n) {
    PyErr_SetString(PyExc_ValueError, "owners and keys must align");
    goto out;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    if (want_touched) {
      int32_t tcount = (int32_t)(touch_off.len / 4);
      if (vec_push(&touch_goff, &tcount, 4) < 0) {
        raise_walk_err();
        goto out;
      }
    }
    PyObject *key_obj = PySequence_Fast_GET_ITEM(kseq, i);
    PyObject *own_obj = PySequence_Fast_GET_ITEM(oseq, i);
    if (!PyBytes_Check(key_obj)) {
      PyErr_SetString(PyExc_TypeError, "keys must be bytes");
      goto out;
    }
    Py_ssize_t owner = PyLong_AsSsize_t(own_obj);
    if (owner == -1 && PyErr_Occurred()) goto out;
    if (owner < 0 || owner >= n_roots) {
      PyErr_SetString(PyExc_ValueError, "owner index out of range");
      goto out;
    }
    PyObject *root_obj = PySequence_Fast_GET_ITEM(rseq, owner);
    if (!PyBytes_Check(root_obj)) {
      PyErr_SetString(PyExc_TypeError, "roots must be bytes (raw CID bytes)");
      goto out;
    }
    uint8_t f = 0;
    int32_t voff = 0, vlen = 0;
    if (hamt_get_one(&s, (const uint8_t *)PyBytes_AS_STRING(root_obj),
                     PyBytes_GET_SIZE(root_obj),
                     (const uint8_t *)PyBytes_AS_STRING(key_obj),
                     PyBytes_GET_SIZE(key_obj), bit_width, &val_pool, &voff,
                     &vlen, &f) < 0) {
      if (!PyErr_Occurred()) raise_walk_err();
      goto out;
    }
    if (vec_push(&found, &f, 1) < 0 || vec_push(&val_off, &voff, 4) < 0 ||
        vec_push(&val_len, &vlen, 4) < 0) {
      raise_walk_err();
      goto out;
    }
  }
  if (want_touched) {
    int32_t tcount = (int32_t)(touch_off.len / 4);
    if (vec_push(&touch_goff, &tcount, 4) < 0) {
      raise_walk_err();
      goto out;
    }
    result = Py_BuildValue(
        "{s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N}", "found", make_array_bytes(&found),
        "val_pool", make_array_bytes(&val_pool), "val_off",
        make_array_bytes(&val_off), "val_len", make_array_bytes(&val_len),
        "touch_pool", make_array_bytes(&touch_pool), "touch_off",
        make_array_bytes(&touch_off), "touch_len", make_array_bytes(&touch_len),
        "touch_goff", make_array_bytes(&touch_goff));
  } else {
    result = Py_BuildValue(
        "{s:N,s:N,s:N,s:N}", "found", make_array_bytes(&found), "val_pool",
        make_array_bytes(&val_pool), "val_off", make_array_bytes(&val_off),
        "val_len", make_array_bytes(&val_len));
  }
out:
  Py_DECREF(rseq);
  Py_DECREF(oseq);
  Py_DECREF(kseq);
  vec_free(&found);
  vec_free(&val_pool);
  vec_free(&val_off);
  vec_free(&val_len);
  vec_free(&touch_pool);
  vec_free(&touch_off);
  vec_free(&touch_len);
  vec_free(&touch_goff);
  return result;
}

static PyObject *py_split_pool(PyObject *self, PyObject *args) {
  (void)self;
  Py_buffer pool, off, len;
  if (!PyArg_ParseTuple(args, "y*y*y*", &pool, &off, &len)) return NULL;
  PyObject *out = NULL;
  Py_ssize_t n = off.len / 4;
  if (off.len % 4 != 0 || len.len != off.len) {
    PyErr_SetString(PyExc_ValueError,
                    "split_pool: off/len must be equal-length i32 arrays");
    goto done;
  }
  const int32_t *offs = (const int32_t *)off.buf;
  const int32_t *lens = (const int32_t *)len.buf;
  out = PyList_New(n);
  if (!out) goto done;
  for (Py_ssize_t i = 0; i < n; i++) {
    int32_t o = offs[i], l = lens[i];
    if (o < 0 || l < 0 || (int64_t)o + (int64_t)l > (int64_t)pool.len) {
      Py_DECREF(out);
      out = NULL;
      PyErr_SetString(PyExc_ValueError, "split_pool: slice out of bounds");
      goto done;
    }
    PyObject *b = PyBytes_FromStringAndSize((const char *)pool.buf + o, l);
    if (!b) {
      Py_DECREF(out);
      out = NULL;
      goto done;
    }
    PyList_SET_ITEM(out, i, b);
  }
done:
  PyBuffer_Release(&pool);
  PyBuffer_Release(&off);
  PyBuffer_Release(&len);
  return out;
}

/* ---------------- claim construction ----------------
 *
 * The tail of Phase C: turn the matched rows' columns into
 * EventProof/EventData instances. The Python loop paid ~2 us per claim in
 * dict+instance construction and hex rendering; this builds the kwargs
 * dicts and instances in C (instance + `__dict__` assignment — the C
 * mirror of EventProof._make) with hex rendered straight from the pools.
 * Slicing semantics mirror Python's (out-of-range clamps, never raises),
 * so malformed inputs produce byte-identical claims to the Python loop. */

static PyObject *hex0x_from(const uint8_t *pool, Py_ssize_t pool_len,
                            Py_ssize_t start, Py_ssize_t stop) {
  static const char digits[] = "0123456789abcdef";
  if (start < 0) start = 0;
  if (stop > pool_len) stop = pool_len;
  if (stop < start) stop = start;
  Py_ssize_t n = stop - start;
  PyObject *out = PyUnicode_New(2 + 2 * n, 127);
  if (!out) return NULL;
  Py_UCS1 *buf = PyUnicode_1BYTE_DATA(out);
  buf[0] = '0';
  buf[1] = 'x';
  for (Py_ssize_t i = 0; i < n; i++) {
    buf[2 + 2 * i] = (Py_UCS1)digits[pool[start + i] >> 4];
    buf[3 + 2 * i] = (Py_UCS1)digits[pool[start + i] & 15];
  }
  return out;
}

/* build one instance of `cls` whose __dict__ becomes `fields` (stolen) —
 * EventProof._make / EventData._make semantics */
static PyObject *instance_with_dict(PyTypeObject *cls, PyObject *fields) {
  PyObject *inst = cls->tp_alloc(cls, 0);
  if (!inst) {
    Py_DECREF(fields);
    return NULL;
  }
  if (PyObject_SetAttrString(inst, "__dict__", fields) < 0) {
    Py_DECREF(fields);
    Py_DECREF(inst);
    return NULL;
  }
  Py_DECREF(fields);
  return inst;
}

typedef struct {
  Py_buffer view;
  const void *buf;
  Py_ssize_t n; /* element count */
} ClaimBuf;

static int claim_buf(PyObject *obj, int itemsize, ClaimBuf *out,
                     const char *name) {
  if (PyObject_GetBuffer(obj, &out->view, PyBUF_SIMPLE) < 0) return -1;
  if (out->view.len % itemsize != 0) {
    PyBuffer_Release(&out->view);
    PyErr_Format(PyExc_ValueError, "%s buffer size not a multiple of %d",
                 name, itemsize);
    return -1;
  }
  out->buf = out->view.buf;
  out->n = out->view.len / itemsize;
  return 0;
}

static PyObject *py_build_event_claims(PyObject *self, PyObject *args,
                                       PyObject *kwargs) {
  (void)self;
  PyObject *strs, *rows_o, *group_o, *msgpos_o, *sbase_o, *nparents_o,
      *pepoch_o, *cepoch_o, *exec_o, *event_o, *emit_o, *ntop_o, *toff_o,
      *doff_o, *dlen_o, *proof_cls, *data_cls;
  Py_buffer tpool, dpool;
  static char *kwlist[] = {
      "strs",       "rows",       "group_of",  "msg_pos",     "str_base",
      "n_parents",  "parent_epoch", "child_epoch", "exec_idx", "event_idx",
      "emitters",   "n_topics",   "topics_off", "data_off",   "data_len",
      "topics_pool", "data_pool", "proof_cls", "data_cls",    NULL};
  if (!PyArg_ParseTupleAndKeywords(
          args, kwargs, "O!OOOOOOOOOOOOOOy*y*OO", kwlist, &PyList_Type, &strs,
          &rows_o, &group_o, &msgpos_o, &sbase_o, &nparents_o, &pepoch_o,
          &cepoch_o, &exec_o, &event_o, &emit_o, &ntop_o, &toff_o, &doff_o,
          &dlen_o, &tpool, &dpool, &proof_cls, &data_cls))
    return NULL;
  PyObject *result = NULL;
  ClaimBuf rows = {0}, group = {0}, msgpos = {0}, sbase = {0}, nparents = {0},
           pepoch = {0}, cepoch = {0}, execb = {0}, eventb = {0}, emitb = {0},
           ntopb = {0}, toffb = {0}, doffb = {0}, dlenb = {0};
  int have = 0;
  if (!PyType_Check(proof_cls) || !PyType_Check(data_cls)) {
    PyErr_SetString(PyExc_TypeError, "proof_cls/data_cls must be types");
    goto done;
  }
  if (claim_buf(rows_o, 8, &rows, "rows") < 0) goto done;
  have = 1;
  if (claim_buf(group_o, 8, &group, "group_of") < 0) goto done;
  have = 2;
  if (claim_buf(msgpos_o, 8, &msgpos, "msg_pos") < 0) goto done;
  have = 3;
  if (claim_buf(sbase_o, 8, &sbase, "str_base") < 0) goto done;
  have = 4;
  if (claim_buf(nparents_o, 8, &nparents, "n_parents") < 0) goto done;
  have = 5;
  if (claim_buf(pepoch_o, 8, &pepoch, "parent_epoch") < 0) goto done;
  have = 6;
  if (claim_buf(cepoch_o, 8, &cepoch, "child_epoch") < 0) goto done;
  have = 7;
  if (claim_buf(exec_o, 4, &execb, "exec_idx") < 0) goto done;
  have = 8;
  if (claim_buf(event_o, 4, &eventb, "event_idx") < 0) goto done;
  have = 9;
  if (claim_buf(emit_o, 8, &emitb, "emitters") < 0) goto done;
  have = 10;
  if (claim_buf(ntop_o, 4, &ntopb, "n_topics") < 0) goto done;
  have = 11;
  if (claim_buf(toff_o, 4, &toffb, "topics_off") < 0) goto done;
  have = 12;
  if (claim_buf(doff_o, 4, &doffb, "data_off") < 0) goto done;
  have = 13;
  if (claim_buf(dlen_o, 4, &dlenb, "data_len") < 0) goto done;
  have = 14;

  {
    Py_ssize_t n_claims = rows.n;
    Py_ssize_t n_groups = sbase.n;
    Py_ssize_t n_strs = PyList_GET_SIZE(strs);
    const int64_t *rows_a = (const int64_t *)rows.buf;
    const int64_t *group_a = (const int64_t *)group.buf;
    const int64_t *msgpos_a = (const int64_t *)msgpos.buf;
    const int64_t *sbase_a = (const int64_t *)sbase.buf;
    const int64_t *nparents_a = (const int64_t *)nparents.buf;
    const int64_t *pepoch_a = (const int64_t *)pepoch.buf;
    const int64_t *cepoch_a = (const int64_t *)cepoch.buf;
    const int32_t *exec_a = (const int32_t *)execb.buf;
    const int32_t *event_a = (const int32_t *)eventb.buf;
    const uint64_t *emit_a = (const uint64_t *)emitb.buf;
    const int32_t *ntop_a = (const int32_t *)ntopb.buf;
    const uint32_t *toff_a = (const uint32_t *)toffb.buf;
    const uint32_t *doff_a = (const uint32_t *)doffb.buf;
    const uint32_t *dlen_a = (const uint32_t *)dlenb.buf;
    if (group.n != n_claims || msgpos.n != n_claims) {
      PyErr_SetString(PyExc_ValueError, "claim column length mismatch");
      goto done;
    }
    if (nparents.n != n_groups || pepoch.n != n_groups ||
        cepoch.n != n_groups) {
      PyErr_SetString(PyExc_ValueError, "group column length mismatch");
      goto done;
    }
    Py_ssize_t n_rows_total = execb.n;
    if (eventb.n != n_rows_total || emitb.n != n_rows_total ||
        ntopb.n != n_rows_total || toffb.n != n_rows_total ||
        doffb.n != n_rows_total || dlenb.n != n_rows_total) {
      PyErr_SetString(PyExc_ValueError, "row column length mismatch");
      goto done;
    }
    result = PyList_New(n_claims);
    if (!result) goto done;
    for (Py_ssize_t j = 0; j < n_claims; j++) {
      int64_t row = rows_a[j], g = group_a[j], mp = msgpos_a[j];
      if (g < 0 || g >= n_groups || row < 0 || row >= n_rows_total ||
          mp < 0 || mp >= n_strs) {
        PyErr_SetString(PyExc_IndexError, "claim index out of range");
        goto claims_fail;
      }
      int64_t base = sbase_a[g], np_ = nparents_a[g];
      if (base < 0 || np_ < 0 || base + np_ >= n_strs) {
        PyErr_SetString(PyExc_IndexError, "group string span out of range");
        goto claims_fail;
      }
      /* event_data */
      int32_t nt = ntop_a[row];
      if (nt < 0) nt = 0;
      PyObject *topics = PyList_New(nt);
      if (!topics) goto claims_fail;
      for (int32_t k = 0; k < nt; k++) {
        Py_ssize_t start = (Py_ssize_t)toff_a[row] + 32 * (Py_ssize_t)k;
        PyObject *t = hex0x_from((const uint8_t *)tpool.buf, tpool.len,
                                 start, start + 32);
        if (!t) {
          Py_DECREF(topics);
          goto claims_fail;
        }
        PyList_SET_ITEM(topics, k, t);
      }
      PyObject *data_str =
          hex0x_from((const uint8_t *)dpool.buf, dpool.len,
                     (Py_ssize_t)doff_a[row],
                     (Py_ssize_t)doff_a[row] + (Py_ssize_t)dlen_a[row]);
      if (!data_str) {
        Py_DECREF(topics);
        goto claims_fail;
      }
      /* explicit dict construction: Py_BuildValue's "N" does not release
       * pre-consumed arguments on failure, so an allocation failure
       * mid-batch would leak the built topics/data/parents objects */
      PyObject *emitter = PyLong_FromUnsignedLongLong(emit_a[row]);
      PyObject *ed_fields = emitter ? PyDict_New() : NULL;
      int ed_ok =
          ed_fields != NULL &&
          PyDict_SetItemString(ed_fields, "emitter", emitter) == 0 &&
          PyDict_SetItemString(ed_fields, "topics", topics) == 0 &&
          PyDict_SetItemString(ed_fields, "data", data_str) == 0;
      Py_XDECREF(emitter);
      Py_DECREF(topics);
      Py_DECREF(data_str);
      if (!ed_ok) {
        Py_XDECREF(ed_fields);
        goto claims_fail;
      }
      PyObject *event_data =
          instance_with_dict((PyTypeObject *)data_cls, ed_fields);
      if (!event_data) goto claims_fail;

      PyObject *parents = PyList_GetSlice(strs, base, base + np_);
      PyObject *pe = PyLong_FromLongLong(pepoch_a[g]);
      PyObject *ce = PyLong_FromLongLong(cepoch_a[g]);
      PyObject *xi = PyLong_FromLong(exec_a[row]);
      PyObject *ei = PyLong_FromLong(event_a[row]);
      PyObject *fields =
          (parents && pe && ce && xi && ei) ? PyDict_New() : NULL;
      int ok_f =
          fields != NULL &&
          PyDict_SetItemString(fields, "parent_epoch", pe) == 0 &&
          PyDict_SetItemString(fields, "child_epoch", ce) == 0 &&
          PyDict_SetItemString(fields, "parent_tipset_cids", parents) == 0 &&
          PyDict_SetItemString(fields, "child_block_cid",
                               PyList_GET_ITEM(strs, base + np_)) == 0 &&
          PyDict_SetItemString(fields, "message_cid",
                               PyList_GET_ITEM(strs, mp)) == 0 &&
          PyDict_SetItemString(fields, "exec_index", xi) == 0 &&
          PyDict_SetItemString(fields, "event_index", ei) == 0 &&
          PyDict_SetItemString(fields, "event_data", event_data) == 0;
      Py_XDECREF(parents);
      Py_XDECREF(pe);
      Py_XDECREF(ce);
      Py_XDECREF(xi);
      Py_XDECREF(ei);
      Py_DECREF(event_data);
      if (!ok_f) {
        Py_XDECREF(fields);
        goto claims_fail;
      }
      PyObject *proof = instance_with_dict((PyTypeObject *)proof_cls, fields);
      if (!proof) goto claims_fail;
      PyList_SET_ITEM(result, j, proof);
    }
    goto done;
  claims_fail:
    Py_CLEAR(result);
  }

done:
  if (have >= 1) PyBuffer_Release(&rows.view);
  if (have >= 2) PyBuffer_Release(&group.view);
  if (have >= 3) PyBuffer_Release(&msgpos.view);
  if (have >= 4) PyBuffer_Release(&sbase.view);
  if (have >= 5) PyBuffer_Release(&nparents.view);
  if (have >= 6) PyBuffer_Release(&pepoch.view);
  if (have >= 7) PyBuffer_Release(&cepoch.view);
  if (have >= 8) PyBuffer_Release(&execb.view);
  if (have >= 9) PyBuffer_Release(&eventb.view);
  if (have >= 10) PyBuffer_Release(&emitb.view);
  if (have >= 11) PyBuffer_Release(&ntopb.view);
  if (have >= 12) PyBuffer_Release(&toffb.view);
  if (have >= 13) PyBuffer_Release(&doffb.view);
  if (have >= 14) PyBuffer_Release(&dlenb.view);
  PyBuffer_Release(&tpool);
  PyBuffer_Release(&dpool);
  return result;
}

/* ---------------- witness materialization ----------------
 *
 * Phase D of the range driver: turn the deduplicated witness CID-byte set
 * into the bundle's CID-sorted ProofBlock list. The Python loop paid a
 * dict probe + CID indexing + a Python-level fast-constructor call per
 * block (~2 us x thousands of blocks per chunk); this does the sort, the
 * probes (snapshot table first), and the instance construction in C. CID
 * objects still come from ONE call to the passed make_cids batch (the
 * dagcbor extension owns the CID type), so acceptance of malformed CID
 * bytes is exactly the Python path's. */

typedef struct {
  const uint8_t *ptr;
  Py_ssize_t len;
  PyObject *obj;
} SortSpan;

static int span_cmp(const void *a, const void *b) {
  const SortSpan *x = (const SortSpan *)a, *y = (const SortSpan *)b;
  Py_ssize_t n = x->len < y->len ? x->len : y->len;
  int c = memcmp(x->ptr, y->ptr, (size_t)n);
  if (c) return c;
  return x->len < y->len ? -1 : (x->len > y->len ? 1 : 0);
}

static PyObject *py_materialize_blocks(PyObject *self, PyObject *args,
                                       PyObject *kwargs) {
  (void)self;
  PyObject *blocks, *todo, *make_cids, *cls;
  PyObject *fallback = Py_None, *snap_obj = Py_None;
  static char *kwlist[] = {"blocks", "todo",     "make_cids", "cls",
                           "fallback", "snapshot", NULL};
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "O!OOO|OO", kwlist,
                                   &PyDict_Type, &blocks, &todo, &make_cids,
                                   &cls, &fallback, &snap_obj))
    return NULL;
  if (!PyType_Check(cls)) {
    PyErr_SetString(PyExc_TypeError, "cls must be a type");
    return NULL;
  }
  const CMap *snap_map = NULL;
  if (snapshot_resolve(snap_obj, blocks, &snap_map, NULL) < 0)
    return NULL;
  PyObject *seq = PySequence_Fast(todo, "todo must be a sequence of cid bytes");
  if (!seq) return NULL;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);

  SortSpan *spans = malloc(sizeof(SortSpan) * (n ? n : 1));
  PyObject *sorted_list = NULL, *cids = NULL, *result = NULL;
  PyObject *name_cid = NULL, *name_data = NULL;
  if (!spans) {
    PyErr_NoMemory();
    goto out;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
    if (!PyBytes_Check(item)) {
      PyErr_SetString(PyExc_TypeError, "todo entries must be cid bytes");
      goto out;
    }
    spans[i].ptr = (const uint8_t *)PyBytes_AS_STRING(item);
    spans[i].len = PyBytes_GET_SIZE(item);
    spans[i].obj = item;
  }
  qsort(spans, (size_t)n, sizeof(SortSpan), span_cmp);

  sorted_list = PyList_New(n);
  if (!sorted_list) goto out;
  for (Py_ssize_t i = 0; i < n; i++) {
    Py_INCREF(spans[i].obj);
    PyList_SET_ITEM(sorted_list, i, spans[i].obj);
  }
  /* ONE batch call constructs every CID object (dagcbor ext's make_cids);
   * malformed bytes raise exactly as the Python loop's */
  cids = PyObject_CallOneArg(make_cids, sorted_list);
  if (!cids) goto out;
  PyObject *cid_seq = PySequence_Fast(cids, "make_cids must return a sequence");
  if (!cid_seq) goto out;
  if (PySequence_Fast_GET_SIZE(cid_seq) != n) {
    Py_DECREF(cid_seq);
    PyErr_SetString(PyExc_ValueError, "make_cids returned wrong length");
    goto out;
  }

  name_cid = PyUnicode_InternFromString("cid");
  name_data = PyUnicode_InternFromString("data");
  if (!name_cid || !name_data) {
    Py_DECREF(cid_seq);
    goto out;
  }
  PyTypeObject *tp = (PyTypeObject *)cls;
  result = PyList_New(n);
  if (!result) {
    Py_DECREF(cid_seq);
    goto out;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *data = NULL; /* borrowed or owned per branch below */
    PyObject *owned = NULL;
    if (snap_map) {
      const CEntry *e = cmap_get(snap_map, spans[i].ptr, spans[i].len);
      if (e && e->vobj && PyBytes_Check(e->vobj)) data = e->vobj;
    }
    if (!data) {
      data = PyDict_GetItemWithError(blocks, spans[i].obj);
      if (!data && PyErr_Occurred()) goto item_fail;
    }
    PyObject *cid = PySequence_Fast_GET_ITEM(cid_seq, i);
    if (!data && fallback != Py_None) {
      owned = PyObject_CallOneArg(fallback, cid);
      if (!owned) goto item_fail;
      if (owned == Py_None) {
        Py_CLEAR(owned);
      } else {
        data = owned;
      }
    }
    if (!data) {
      PyErr_Format(PyExc_KeyError, "missing witness block %S", cid);
      goto item_fail;
    }
    /* ProofBlock._make from C: bare instance + generic setattr (bypasses
     * the frozen-dataclass __setattr__ exactly like object.__setattr__) */
    PyObject *inst = tp->tp_alloc(tp, 0);
    if (!inst) goto item_fail;
    if (PyObject_GenericSetAttr(inst, name_cid, cid) < 0 ||
        PyObject_GenericSetAttr(inst, name_data, data) < 0) {
      Py_DECREF(inst);
      goto item_fail;
    }
    Py_XDECREF(owned);
    PyList_SET_ITEM(result, i, inst);
    continue;
  item_fail:
    Py_XDECREF(owned);
    Py_DECREF(cid_seq);
    Py_CLEAR(result);
    goto out;
  }
  Py_DECREF(cid_seq);

out:
  free(spans);
  Py_XDECREF(sorted_list);
  Py_XDECREF(cids);
  Py_XDECREF(name_cid);
  Py_XDECREF(name_data);
  Py_DECREF(seq);
  return result;
}

/* the effective scan fan-out (IPC_SCAN_THREADS env or core count, capped)
 * — exposed so observability (bench JSON) reports exactly what the
 * scanner uses instead of re-deriving it with divergent logic */
static PyObject *py_scan_threads(PyObject *self, PyObject *noarg) {
  (void)self;
  (void)noarg;
  return PyLong_FromLong(scan_threads_default());
}

static PyMethodDef methods[] = {
    {"scan_threads", py_scan_threads, METH_NOARGS,
     "Effective scan thread count (IPC_SCAN_THREADS env or capped core "
     "count) — the value scan_events_batch fans out to."},
    {"split_pool", py_split_pool, METH_VARARGS,
     "split_pool(pool, off_i32, len_i32) -> list[bytes]: materialize every "
     "pooled item in one call."},
    {"scan_events_batch", (PyCFunction)(void (*)(void))py_scan_events_batch,
     METH_VARARGS | METH_KEYWORDS,
     "scan_events_batch(blocks_dict, roots, fallback=None, skip_missing=False,"
     " want_payload=False, threads=None) -> dict of flat array buffers over "
     "every event of every receipt of every root. threads caps this call's "
     "pthread fan-out (None = IPC_SCAN_THREADS / core default)."},
    {"collect_exec_orders",
     (PyCFunction)(void (*)(void))py_collect_exec_orders,
     METH_VARARGS | METH_KEYWORDS,
     "collect_exec_orders(blocks_dict, groups, fallback=None, headers=True) ->"
     " per-group message-CID lists (execution order, first-seen deduped), touched block"
     " CIDs, TxMeta CIDs + canonical flags, and failed flags."},
    {"hamt_lookup_batch",
     (PyCFunction)(void (*)(void))py_hamt_lookup_batch,
     METH_VARARGS | METH_KEYWORDS,
     "hamt_lookup_batch(blocks_dict, roots, owners, keys, bit_width=5, "
     "fallback=None, skip_missing=False) -> one root→bucket HAMT walk per "
     "(owner root, key), returning found flags and raw value-CBOR spans "
     "(pooled) — the batched storage-slot lookup path."},
    {"record_receipt_paths",
     (PyCFunction)(void (*)(void))py_record_receipt_paths,
     METH_VARARGS | METH_KEYWORDS,
     "record_receipt_paths(blocks_dict, roots, wanted, fallback=None) -> "
     "pass 2 of the event generator batched: per group, targeted receipts-AMT"
     " path walks to each wanted index plus full events-AMT walks beneath,"
     " returning flat payload-mode event arrays, touched block CIDs (grouped),"
     " and per-group failed flags."},
    {"build_event_claims",
     (PyCFunction)(void (*)(void))py_build_event_claims,
     METH_VARARGS | METH_KEYWORDS,
     "build_event_claims(strs, rows, group_of, msg_pos, str_base, n_parents,"
     " parent_epoch, child_epoch, exec_idx, event_idx, emitters, n_topics,"
     " topics_off, data_off, data_len, topics_pool, data_pool, proof_cls,"
     " data_cls) -> list[EventProof] — Phase C claim construction in C."},
    {"materialize_blocks",
     (PyCFunction)(void (*)(void))py_materialize_blocks,
     METH_VARARGS | METH_KEYWORDS,
     "materialize_blocks(blocks_dict, todo, make_cids, cls, fallback=None, "
     "snapshot=None) -> CID-byte-sorted list of cls instances (cid=, data=) "
     "— Phase D witness materialization in one C pass."},
    {"bulk_load_blocks", py_bulk_load_blocks, METH_VARARGS,
     "bulk_load_blocks(blocks, cid_dict, raw_dict) -> count: load "
     "ProofBlock-shaped items into a MemoryBlockstore's two maps in one "
     "C pass (the witness loader's hot loop)."},
    {"make_snapshot", py_make_snapshot, METH_O,
     "make_snapshot(blocks_dict) -> BlockSnapshot: persistent GIL-free "
     "probe table over the dict, reusable across native walks via their "
     "snapshot= argument (hits stay valid because content-addressed stores "
     "only add blocks; misses fall through to the live dict)."},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "ipc_torch_scan_ext",
                                       "Native receipts/events AMT scanner",
                                       -1, methods, NULL, NULL, NULL, NULL};

PyMODINIT_FUNC PyInit_ipc_torch_scan_ext(void) {
  PyObject *m = PyModule_Create(&moduledef);
  if (!m) return NULL;
  if (PyType_Ready(&Snapshot_Type) < 0 ||
      PyModule_AddObjectRef(m, "BlockSnapshot",
                            (PyObject *)&Snapshot_Type) < 0 ||
      /* advertises the threads= kwarg of scan_events_batch, as the
       * reference's extension does (the port's callers always pass it) */
      PyModule_AddIntConstant(m, "SCAN_BATCH_THREADS_KW", 1) < 0) {
    Py_DECREF(m);
    return NULL;
  }
  return m;
}
