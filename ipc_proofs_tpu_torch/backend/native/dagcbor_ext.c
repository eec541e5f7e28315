/* Fast DAG-CBOR decoder as a CPython extension.
 *
 * The port's copy of ipc_proofs_tpu/backend/native/dagcbor_ext.c, built
 * as the module ipc_torch_dagcbor_ext (its CID type is
 * ipc_torch_dagcbor_ext.CID) so a process can hold both copies.
 *
 * The pure-Python decoder (core/dagcbor.py) is the correctness reference;
 * this module accelerates the bulk decode paths (witness loading, receipt/
 * event scanning — the host Phase A of the range driver). pybind11 is not
 * available in this environment, so it uses the raw CPython C API.
 *
 * CIDs (tag 42) are produced through a factory callable registered from
 * Python (set_cid_factory), so the extension does not need to know the CID
 * class layout.
 *
 * Build: g++/gcc -O2 -shared -fPIC -I<python-include> dagcbor_ext.c \
 *        -o ipc_torch_dagcbor_ext.so
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

static PyObject *cid_factory = NULL; /* callable(bytes) -> CID */
static PyObject *cid_class = NULL;   /* the CID class for direct C construction */
static PyObject *s_version, *s_codec, *s_mh_code, *s_digest, *s_bytes;

/* Nesting cap for the recursive walkers: attacker-controlled witness
 * bytes must exhaust a counter, not the C stack. Real chain objects nest
 * < 20 deep; the pure-Python decoder enforces the same bound. */
#define MAX_CBOR_DEPTH 512

typedef struct {
  const uint8_t *data;
  Py_ssize_t len;
  Py_ssize_t pos;
  int depth;
} Parser;

static int depth_enter(Parser *p) {
  if (++p->depth > MAX_CBOR_DEPTH) {
    PyErr_SetString(PyExc_ValueError, "CBOR nesting too deep");
    return -1;
  }
  return 0;
}

static PyObject *parse_item(Parser *p);
static PyObject *make_cid(const uint8_t *raw, Py_ssize_t n);

static int parse_head(Parser *p, int *major, uint64_t *value) {
  if (p->pos >= p->len) {
    PyErr_SetString(PyExc_ValueError, "truncated CBOR head");
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
      PyErr_SetString(PyExc_ValueError,
                      "indefinite/reserved CBOR length not allowed in DAG-CBOR");
      return -1;
  }
  if (p->pos + extra > p->len) {
    PyErr_SetString(PyExc_ValueError, "truncated CBOR head");
    return -1;
  }
  uint64_t v = 0;
  for (int i = 0; i < extra; i++) v = (v << 8) | p->data[p->pos++];
  *value = v;
  /* return the info bits so float64 can be distinguished */
  return info;
}

static PyObject *parse_item_inner(Parser *p);

static PyObject *parse_item(Parser *p) {
  if (depth_enter(p) < 0) return NULL;
  PyObject *out = parse_item_inner(p);
  p->depth--;
  return out;
}

static PyObject *parse_item_inner(Parser *p) {
  int major;
  uint64_t value;
  int info = parse_head(p, &major, &value);
  if (info < 0) return NULL;

  switch (major) {
    case 0: /* uint */
      return PyLong_FromUnsignedLongLong(value);
    case 1: /* negint: -1 - value */
      if (value <= (uint64_t)INT64_MAX) {
        return PyLong_FromLongLong(-1 - (int64_t)value);
      } else {
        PyObject *v = PyLong_FromUnsignedLongLong(value);
        if (!v) return NULL;
        PyObject *minus_one = PyLong_FromLong(-1);
        PyObject *result = PyNumber_Subtract(minus_one, v);
        Py_DECREF(minus_one);
        Py_DECREF(v);
        return result;
      }
    case 2: { /* bytes */
      if ((uint64_t)(p->len - p->pos) < value) {
        PyErr_SetString(PyExc_ValueError, "truncated CBOR bytes");
        return NULL;
      }
      PyObject *b = PyBytes_FromStringAndSize((const char *)p->data + p->pos,
                                              (Py_ssize_t)value);
      p->pos += (Py_ssize_t)value;
      return b;
    }
    case 3: { /* text */
      if ((uint64_t)(p->len - p->pos) < value) {
        PyErr_SetString(PyExc_ValueError, "truncated CBOR text");
        return NULL;
      }
      PyObject *s = PyUnicode_DecodeUTF8((const char *)p->data + p->pos,
                                         (Py_ssize_t)value, NULL);
      p->pos += (Py_ssize_t)value;
      return s;
    }
    case 4: { /* array */
      if ((uint64_t)p->len - p->pos < value) { /* cheap DoS guard */
        PyErr_SetString(PyExc_ValueError, "CBOR array length exceeds input");
        return NULL;
      }
      PyObject *list = PyList_New((Py_ssize_t)value);
      if (!list) return NULL;
      for (Py_ssize_t i = 0; i < (Py_ssize_t)value; i++) {
        PyObject *item = parse_item(p);
        if (!item) {
          Py_DECREF(list);
          return NULL;
        }
        PyList_SET_ITEM(list, i, item);
      }
      return list;
    }
    case 5: { /* map */
      PyObject *dict = PyDict_New();
      if (!dict) return NULL;
      for (uint64_t i = 0; i < value; i++) {
        PyObject *key = parse_item(p);
        if (!key) {
          Py_DECREF(dict);
          return NULL;
        }
        if (!PyUnicode_Check(key)) {
          Py_DECREF(key);
          Py_DECREF(dict);
          PyErr_SetString(PyExc_ValueError, "DAG-CBOR map keys must be strings");
          return NULL;
        }
        PyObject *val = parse_item(p);
        if (!val) {
          Py_DECREF(key);
          Py_DECREF(dict);
          return NULL;
        }
        int rc = PyDict_SetItem(dict, key, val);
        Py_DECREF(key);
        Py_DECREF(val);
        if (rc < 0) {
          Py_DECREF(dict);
          return NULL;
        }
      }
      return dict;
    }
    case 6: { /* tag — only 42 (CID) */
      if (value != 42) {
        PyErr_Format(PyExc_ValueError, "unsupported CBOR tag %llu",
                     (unsigned long long)value);
        return NULL;
      }
      PyObject *inner = parse_item(p);
      if (!inner) return NULL;
      if (!PyBytes_Check(inner) || PyBytes_GET_SIZE(inner) < 1 ||
          PyBytes_AS_STRING(inner)[0] != 0) {
        Py_DECREF(inner);
        PyErr_SetString(PyExc_ValueError,
                        "tag-42 content must be identity-multibase CID bytes");
        return NULL;
      }
      /* direct construction of the native CID type — no Python call and
       * no per-field attribute write per link */
      PyObject *cid =
          make_cid((const uint8_t *)PyBytes_AS_STRING(inner) + 1,
                   PyBytes_GET_SIZE(inner) - 1);
      Py_DECREF(inner);
      return cid;
    }
    case 7: /* simple / float */
      if (info == 27) { /* f64: value holds the raw payload */
        double d;
        uint64_t bits = value;
        memcpy(&d, &bits, 8);
        return PyFloat_FromDouble(d);
      }
      if (value == 20) Py_RETURN_FALSE;
      if (value == 21) Py_RETURN_TRUE;
      if (value == 22) Py_RETURN_NONE;
      PyErr_Format(PyExc_ValueError, "unsupported CBOR simple value %llu",
                   (unsigned long long)value);
      return NULL;
  }
  PyErr_SetString(PyExc_ValueError, "unreachable CBOR major type");
  return NULL;
}

/* ---------------- validating skip (no object materialization) ----------
 *
 * skip_item walks exactly the grammar parse_item accepts — including
 * strict UTF-8 text validation, string-keyed maps, tag-42 CID byte
 * validation (mirroring CID.from_bytes), and the same error ordering —
 * without building Python objects. Used by decode_header to skip the
 * block-header fields verification never reads. */

static int utf8_valid(const uint8_t *s, Py_ssize_t n) {
  Py_ssize_t i = 0;
  while (i < n) {
    uint8_t c = s[i];
    if (c < 0x80) {
      i++;
    } else if (c < 0xC2) { /* bare continuation / overlong C0-C1 */
      return 0;
    } else if (c < 0xE0) { /* 2-byte */
      if (i + 1 >= n || (s[i + 1] & 0xC0) != 0x80) return 0;
      i += 2;
    } else if (c < 0xF0) { /* 3-byte */
      if (i + 2 >= n || (s[i + 1] & 0xC0) != 0x80 || (s[i + 2] & 0xC0) != 0x80)
        return 0;
      if (c == 0xE0 && s[i + 1] < 0xA0) return 0; /* overlong */
      if (c == 0xED && s[i + 1] >= 0xA0) return 0; /* surrogate */
      i += 3;
    } else if (c < 0xF5) { /* 4-byte */
      if (i + 3 >= n || (s[i + 1] & 0xC0) != 0x80 ||
          (s[i + 2] & 0xC0) != 0x80 || (s[i + 3] & 0xC0) != 0x80)
        return 0;
      if (c == 0xF0 && s[i + 1] < 0x90) return 0; /* overlong */
      if (c == 0xF4 && s[i + 1] >= 0x90) return 0; /* > U+10FFFF */
      i += 4;
    } else {
      return 0;
    }
  }
  return 1;
}

/* unsigned LEB128, mirroring core/varint.py decode_uvarint exactly:
 * at most 10 bytes (shift > 63 after a continuation byte errors), 128-bit
 * accumulation so oversized values compare/fail like Python's bignums. */
static int cid_uvarint_errkind; /* 1 = truncated, 2 = too long (last failure) */

static int cid_uvarint(const uint8_t *d, Py_ssize_t n, Py_ssize_t *pos,
                       unsigned __int128 *out) {
  unsigned __int128 value = 0;
  int shift = 0;
  for (;;) {
    if (*pos >= n) {
      cid_uvarint_errkind = 1; /* truncated uvarint */
      return -1;
    }
    uint8_t b = d[(*pos)++];
    value |= (unsigned __int128)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = value;
      return 0;
    }
    shift += 7;
    if (shift > 63) {
      cid_uvarint_errkind = 2; /* uvarint too long */
      return -1;
    }
  }
}

/* like cid_uvarint but flags non-minimal encodings (a multi-byte varint
 * whose most significant group is zero) — every decode boundary rejects
 * those, so only canonical encodings ever construct a CID */
static int cid_uvarint_min(const uint8_t *d, Py_ssize_t n, Py_ssize_t *pos,
                           unsigned __int128 *out, int *minimal) {
  Py_ssize_t start = *pos;
  if (cid_uvarint(d, n, pos, out) < 0) return -1;
  *minimal &= (*pos - start) == 1 || d[*pos - 1] != 0;
  return 0;
}

/* CID byte validation with CID.from_bytes acceptance: CIDv1 only, MINIMAL
 * varint (codec, mh_code, mh_len) prefix, digest exactly mh_len bytes,
 * nothing trailing. Used by the validating skip path, which must reject
 * exactly the bytes every decode path rejects — a tolerant check here
 * would let a non-minimal link in a skipped field pass decode_lite while
 * the full decode raises (the lite/full acceptance contract,
 * state/header.py). */
static int cid_bytes_valid(const uint8_t *d, Py_ssize_t n) {
  Py_ssize_t pos = 0;
  unsigned __int128 version, codec, mh_code, mh_len;
  int minimal = 1;
  if (cid_uvarint_min(d, n, &pos, &version, &minimal) < 0 || version != 1)
    return 0;
  if (cid_uvarint_min(d, n, &pos, &codec, &minimal) < 0) return 0;
  if (cid_uvarint_min(d, n, &pos, &mh_code, &minimal) < 0) return 0;
  if (cid_uvarint_min(d, n, &pos, &mh_len, &minimal) < 0) return 0;
  return minimal && (unsigned __int128)(n - pos) == mh_len;
}

/* uvarint values can exceed u64 (shift cap 63 admits up to ~2^70); Python
 * stores bignums, so mirror that exactly */
static PyObject *u128_to_pylong(unsigned __int128 v) {
  if (v <= (unsigned __int128)UINT64_MAX)
    return PyLong_FromUnsignedLongLong((unsigned long long)v);
  unsigned char le[16];
  for (int i = 0; i < 16; i++) le[i] = (unsigned char)(v >> (8 * i));
#if PY_VERSION_HEX >= 0x030D0000 /* 3.13+: public API */
  return PyLong_FromNativeBytes(le, 16,
                                Py_ASNATIVEBYTES_LITTLE_ENDIAN |
                                    Py_ASNATIVEBYTES_UNSIGNED_BUFFER);
#else
  return _PyLong_FromByteArray(le, 16, 1 /* little-endian */, 0 /* unsigned */);
#endif
}

/* ====================== native CID extension type ======================
 *
 * A C-slot CID (the round-5 unlock named in NOTES_r04): the Python
 * dataclass pays a per-instance __dict__ plus one dict insert per field
 * and per memo — measured at ~2.9 µs/header for the 4-5 link CIDs each
 * block header carries, the floor under the verify_replay/record stages.
 * This type stores (version, codec, mh_code) as C uint128 fields, the
 * digest as a bytes object, and memoizes to_bytes/str/hash in C slots.
 * Interface parity with ipc_proofs_tpu.core.cid.CID (the pure-Python
 * fallback, which stays the correctness reference): same constructor
 * signature, classmethods, comparison/hash semantics, and the same
 * strict-canonical acceptance at the bytes and string boundaries
 * (reference stack: the Rust `cid` + `multibase` crates, SURVEY §2b). */

static PyTypeObject CID_Type; /* forward */

/* base32 tables are defined with the batched string codecs below */
static const char b32_alpha[32];
static int8_t b32_val[256];
static int b32_val_ready;
static void b32_val_init(void);

typedef struct {
  PyObject_HEAD
  unsigned __int128 version;
  unsigned __int128 codec;
  unsigned __int128 mh_code;
  PyObject *digest;     /* bytes (any object tolerated, like the dataclass) */
  PyObject *bytes_memo; /* canonical encoding, NULL until computed */
  PyObject *str_memo;   /* multibase base32-lower string, NULL until computed */
  PyObject *field_memo[3]; /* lazily-built PyLongs for version/codec/mh_code */
  Py_hash_t hash_memo;  /* -1 until computed (PyObject_Hash never returns -1) */
} CIDObject;

static void cid_dealloc(CIDObject *o) {
  Py_XDECREF(o->digest);
  Py_XDECREF(o->bytes_memo);
  Py_XDECREF(o->str_memo);
  for (int i = 0; i < 3; i++) Py_XDECREF(o->field_memo[i]);
  PyObject_Free(o);
}

/* core allocator: borrows digest (increfs internally) */
static PyObject *cid_new_parts(unsigned __int128 version, unsigned __int128 codec,
                               unsigned __int128 mh_code, PyObject *digest) {
  CIDObject *o = PyObject_New(CIDObject, &CID_Type);
  if (!o) return NULL;
  o->version = version;
  o->codec = codec;
  o->mh_code = mh_code;
  Py_INCREF(digest);
  o->digest = digest;
  o->bytes_memo = NULL;
  o->str_memo = NULL;
  o->field_memo[0] = o->field_memo[1] = o->field_memo[2] = NULL;
  o->hash_memo = -1;
  return (PyObject *)o;
}

/* exact PyLong -> u128; negative -> ValueError (encode_uvarint parity),
 * > u128 -> OverflowError (the dataclass tolerates arbitrary bignums but
 * nothing real exceeds the varint decoder's ~2^70 cap) */
static int pylong_to_u128(PyObject *v, unsigned __int128 *out) {
  if (!PyLong_Check(v)) {
    PyErr_Format(PyExc_TypeError, "CID field must be int, not %.80s",
                 Py_TYPE(v)->tp_name);
    return -1;
  }
  int overflow;
  long long ll = PyLong_AsLongLongAndOverflow(v, &overflow);
  if (!overflow) {
    if (ll < 0) {
      PyErr_SetString(PyExc_ValueError, "uvarint cannot encode negative values");
      return -1;
    }
    *out = (unsigned __int128)ll;
    return 0;
  }
  if (overflow < 0) {
    PyErr_SetString(PyExc_ValueError, "uvarint cannot encode negative values");
    return -1;
  }
  unsigned char le[16];
#if PY_VERSION_HEX >= 0x030D0000
  /* AsNativeBytes does NOT raise on overflow — it returns the number of
   * bytes the value actually needs; > 16 means truncation happened */
  Py_ssize_t needed = PyLong_AsNativeBytes(
      v, le, 16,
      Py_ASNATIVEBYTES_LITTLE_ENDIAN | Py_ASNATIVEBYTES_UNSIGNED_BUFFER |
          Py_ASNATIVEBYTES_REJECT_NEGATIVE);
  if (needed < 0 || PyErr_Occurred()) return -1;
  if (needed > 16) {
    PyErr_SetString(PyExc_OverflowError, "CID field exceeds 128 bits");
    return -1;
  }
#else
  if (_PyLong_AsByteArray((PyLongObject *)v, le, 16, 1 /* little */,
                          0 /* unsigned: raises on negative/overflow */) < 0)
    return -1;
#endif
  unsigned __int128 acc = 0;
  for (int i = 15; i >= 0; i--) acc = (acc << 8) | le[i];
  *out = acc;
  return 0;
}

static size_t uvarint_put(uint8_t *out, unsigned __int128 v) {
  size_t n = 0;
  do {
    uint8_t b = (uint8_t)(v & 0x7F);
    v >>= 7;
    out[n++] = (uint8_t)(b | (v ? 0x80 : 0));
  } while (v);
  return n;
}

/* to_bytes with C-slot memoization (CID.to_bytes parity: varint header +
 * digest; memo holds the canonical encoding) */
static PyObject *cid_to_bytes_obj(CIDObject *o) {
  if (o->bytes_memo) return Py_NewRef(o->bytes_memo);
  if (!PyBytes_Check(o->digest)) {
    PyErr_SetString(PyExc_TypeError, "CID digest must be bytes to serialize");
    return NULL;
  }
  uint8_t head[4 * 19];
  size_t hn = 0;
  hn += uvarint_put(head + hn, o->version);
  hn += uvarint_put(head + hn, o->codec);
  hn += uvarint_put(head + hn, o->mh_code);
  Py_ssize_t dn = PyBytes_GET_SIZE(o->digest);
  hn += uvarint_put(head + hn, (unsigned __int128)dn);
  PyObject *b = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)hn + dn);
  if (!b) return NULL;
  char *w = PyBytes_AS_STRING(b);
  memcpy(w, head, hn);
  memcpy(w + hn, PyBytes_AS_STRING(o->digest), (size_t)dn);
  o->bytes_memo = b;
  return Py_NewRef(b);
}

static PyObject *cid_to_bytes_meth(CIDObject *o, PyObject *ignored) {
  (void)ignored;
  return cid_to_bytes_obj(o);
}

/* multibase base32-lower render of raw CID bytes ("b" prefix, RFC 4648
 * lower alphabet, no padding) — the single encoder behind CID.__str__ and
 * the batched cid_strs */
static PyObject *b32_render(const uint8_t *d, Py_ssize_t blen) {
  Py_ssize_t nchars = (blen * 8 + 4) / 5;
  PyObject *str = PyUnicode_New(1 + nchars, 127);
  if (!str) return NULL;
  Py_UCS1 *w = PyUnicode_1BYTE_DATA(str);
  *w++ = 'b';
  uint32_t acc = 0;
  int bits = 0;
  for (Py_ssize_t k = 0; k < blen; k++) {
    acc = (acc << 8) | d[k];
    bits += 8;
    while (bits >= 5) {
      bits -= 5;
      *w++ = (Py_UCS1)b32_alpha[(acc >> bits) & 31];
    }
  }
  if (bits) *w++ = (Py_UCS1)b32_alpha[(acc << (5 - bits)) & 31];
  return str;
}

/* memoized CID.__str__ */
static PyObject *cid_str_meth(CIDObject *o) {
  if (o->str_memo) return Py_NewRef(o->str_memo);
  PyObject *raw = cid_to_bytes_obj(o);
  if (!raw) return NULL;
  PyObject *str = b32_render((const uint8_t *)PyBytes_AS_STRING(raw),
                             PyBytes_GET_SIZE(raw));
  Py_DECREF(raw);
  if (!str) return NULL;
  o->str_memo = str;
  return Py_NewRef(str);
}

static PyObject *cid_repr(CIDObject *o) {
  PyObject *s = cid_str_meth(o);
  if (!s) return NULL;
  PyObject *r = PyUnicode_FromFormat("CID(%U)", s);
  Py_DECREF(s);
  return r;
}

static Py_hash_t cid_hash(CIDObject *o) {
  if (o->hash_memo != -1) return o->hash_memo;
  Py_hash_t h = PyObject_Hash(o->digest); /* dataclass parity: hash(digest) */
  if (h == -1) return -1;
  o->hash_memo = h;
  return h;
}

static PyObject *cid_field_pylong(CIDObject *o, int idx) {
  if (!o->field_memo[idx]) {
    unsigned __int128 v = idx == 0 ? o->version : idx == 1 ? o->codec
                                                           : o->mh_code;
    o->field_memo[idx] = u128_to_pylong(v);
    if (!o->field_memo[idx]) return NULL;
  }
  return Py_NewRef(o->field_memo[idx]);
}

static PyObject *cid_get_version(CIDObject *o, void *c) {
  (void)c;
  return cid_field_pylong(o, 0);
}
static PyObject *cid_get_codec(CIDObject *o, void *c) {
  (void)c;
  return cid_field_pylong(o, 1);
}
static PyObject *cid_get_mh_code(CIDObject *o, void *c) {
  (void)c;
  return cid_field_pylong(o, 2);
}
static PyObject *cid_get_digest(CIDObject *o, void *c) {
  (void)c;
  return Py_NewRef(o->digest);
}

static PyGetSetDef cid_getset[] = {
    {"version", (getter)cid_get_version, NULL, "CID version (1)", NULL},
    {"codec", (getter)cid_get_codec, NULL, "content codec (0x71 dag-cbor)", NULL},
    {"mh_code", (getter)cid_get_mh_code, NULL, "multihash code", NULL},
    {"digest", (getter)cid_get_digest, NULL, "multihash digest bytes", NULL},
    {NULL, NULL, NULL, NULL, NULL}};

/* comparisons: EQ/NE by (version, codec, mh_code, digest) like the frozen
 * dataclass; ordering by to_bytes() like CID.__lt__/total_ordering. The
 * duck-typed branch keeps mixed comparison with the pure-Python fallback
 * class working (equivalence tests compare across implementations). */
static PyObject *cid_richcompare(PyObject *a, PyObject *b, int op) {
  CIDObject *x = (CIDObject *)a; /* tp_richcompare: a is always our type */
  if (PyObject_TypeCheck(b, &CID_Type)) {
    CIDObject *y = (CIDObject *)b;
    if (op == Py_EQ || op == Py_NE) {
      int eq = x->version == y->version && x->codec == y->codec &&
               x->mh_code == y->mh_code;
      if (eq) {
        if (PyBytes_CheckExact(x->digest) && PyBytes_CheckExact(y->digest)) {
          Py_ssize_t nx = PyBytes_GET_SIZE(x->digest);
          eq = nx == PyBytes_GET_SIZE(y->digest) &&
               memcmp(PyBytes_AS_STRING(x->digest), PyBytes_AS_STRING(y->digest),
                      (size_t)nx) == 0;
        } else {
          eq = PyObject_RichCompareBool(x->digest, y->digest, Py_EQ);
          if (eq < 0) return NULL;
        }
      }
      return PyBool_FromLong(op == Py_EQ ? eq : !eq);
    }
    PyObject *xb = cid_to_bytes_obj(x);
    if (!xb) return NULL;
    PyObject *yb = cid_to_bytes_obj(y);
    if (!yb) {
      Py_DECREF(xb);
      return NULL;
    }
    PyObject *r = PyObject_RichCompare(xb, yb, op);
    Py_DECREF(xb);
    Py_DECREF(yb);
    return r;
  }
  if (op == Py_EQ || op == Py_NE) {
    static const char *names[] = {"version", "codec", "mh_code", "digest"};
    int eq = 1;
    for (int i = 0; i < 4 && eq; i++) {
      PyObject *theirs = PyObject_GetAttrString(b, names[i]);
      if (!theirs) {
        PyErr_Clear();
        Py_RETURN_NOTIMPLEMENTED;
      }
      PyObject *ours = i == 3 ? Py_NewRef(x->digest) : cid_field_pylong(x, i);
      if (!ours) {
        Py_DECREF(theirs);
        return NULL;
      }
      eq = PyObject_RichCompareBool(ours, theirs, Py_EQ);
      Py_DECREF(ours);
      Py_DECREF(theirs);
      if (eq < 0) return NULL;
    }
    return PyBool_FromLong(op == Py_EQ ? eq : !eq);
  }
  PyObject *their_to_bytes = PyObject_GetAttrString(b, "to_bytes");
  if (!their_to_bytes) {
    PyErr_Clear();
    Py_RETURN_NOTIMPLEMENTED;
  }
  PyObject *yb = PyObject_CallNoArgs(their_to_bytes);
  Py_DECREF(their_to_bytes);
  if (!yb) return NULL;
  PyObject *xb = cid_to_bytes_obj(x);
  if (!xb) {
    Py_DECREF(yb);
    return NULL;
  }
  PyObject *r = PyObject_RichCompare(xb, yb, op);
  Py_DECREF(xb);
  Py_DECREF(yb);
  return r;
}

static PyObject *cid_tp_new(PyTypeObject *type, PyObject *args, PyObject *kwds) {
  (void)type; /* no subclassing (tp_flags has no BASETYPE) */
  static char *kwlist[] = {"version", "codec", "mh_code", "digest", NULL};
  PyObject *pv, *pc, *pm, *pd;
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "OOOO", kwlist, &pv, &pc, &pm,
                                   &pd))
    return NULL;
  unsigned __int128 v, c, m;
  if (pylong_to_u128(pv, &v) < 0 || pylong_to_u128(pc, &c) < 0 ||
      pylong_to_u128(pm, &m) < 0)
    return NULL;
  return cid_new_parts(v, c, m, pd);
}

static PyObject *cid_cls_make(PyObject *cls, PyObject *args, PyObject *kwds) {
  return cid_tp_new((PyTypeObject *)cls, args, kwds);
}

/* CID.from_bytes parity, including the error messages of the pure-Python
 * generic path. detailed=0 gives make_cid's single "malformed CID bytes"
 * (the tag-42 / make_cids boundary). Non-minimal varints REJECT, so every
 * accepted decode is the canonical encoding and raw is always safe to
 * memoize as to_bytes. */
static PyObject *cid_from_raw(const uint8_t *raw, Py_ssize_t n, int detailed) {
  Py_ssize_t pos = 0;
  unsigned __int128 version = 0, codec = 0, mh_code = 0, mh_len = 0;
  int minimal = 1;
  if (cid_uvarint_min(raw, n, &pos, &version, &minimal) < 0) goto uverr;
  if (version != 1) {
    if (!detailed) goto generic;
    PyObject *v = u128_to_pylong(version);
    if (v) {
      PyErr_Format(PyExc_ValueError, "unsupported CID version %S", v);
      Py_DECREF(v);
    }
    return NULL;
  }
  if (cid_uvarint_min(raw, n, &pos, &codec, &minimal) < 0 ||
      cid_uvarint_min(raw, n, &pos, &mh_code, &minimal) < 0 ||
      cid_uvarint_min(raw, n, &pos, &mh_len, &minimal) < 0)
    goto uverr;
  if ((unsigned __int128)(n - pos) < mh_len) {
    if (!detailed) goto generic;
    PyErr_SetString(PyExc_ValueError, "truncated CID multihash digest");
    return NULL;
  }
  if ((unsigned __int128)(n - pos) > mh_len) {
    if (!detailed) goto generic;
    PyErr_SetString(PyExc_ValueError, "trailing bytes after CID");
    return NULL;
  }
  /* strict minimal varints (go-varint / rust unsigned-varint parity):
   * tolerating a non-minimal prefix gives one logical CID two byte forms,
   * and the batch walkers' raw spans then disagree with the scalar
   * decoders' canonical re-encodes (round-5 exec-order fuzz find). */
  if (!minimal) {
    if (!detailed) goto generic;
    PyErr_SetString(PyExc_ValueError, "non-canonical CID byte encoding");
    return NULL;
  }
  {
    PyObject *digest =
        PyBytes_FromStringAndSize((const char *)raw + pos, n - pos);
    if (!digest) return NULL;
    CIDObject *o = (CIDObject *)cid_new_parts(version, codec, mh_code, digest);
    Py_DECREF(digest);
    if (!o) return NULL;
    o->bytes_memo = PyBytes_FromStringAndSize((const char *)raw, n);
    if (!o->bytes_memo) {
      Py_DECREF(o);
      return NULL;
    }
    return (PyObject *)o;
  }
uverr:
  if (detailed) {
    /* decode_uvarint parity: truncation vs the 10-byte length cap */
    PyErr_SetString(PyExc_ValueError, cid_uvarint_errkind == 2
                                          ? "uvarint too long"
                                          : "truncated uvarint");
    return NULL;
  }
generic:
  PyErr_SetString(PyExc_ValueError, "malformed CID bytes");
  return NULL;
}

/* tolerant construction from raw CID bytes (tag-42 links, make_cids) */
static PyObject *make_cid(const uint8_t *raw, Py_ssize_t n) {
  return cid_from_raw(raw, n, 0);
}

static PyObject *cid_cls_from_bytes(PyObject *cls, PyObject *arg) {
  (void)cls;
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
  PyObject *out = cid_from_raw((const uint8_t *)view.buf, view.len, 1);
  PyBuffer_Release(&view);
  return out;
}

/* single-string CID.from_string core (strict canonical multibase base32:
 * 'b' prefix, lowercase alphabet, valid unpadded length class, zero
 * trailing bits, minimal varints) — shared by the classmethod and the
 * batched cids_from_strs loop. */
static PyObject *cid_from_str_item(PyObject *item) {
  if (!b32_val_ready) b32_val_init();
  Py_ssize_t slen;
  const char *s =
      PyUnicode_Check(item) ? PyUnicode_AsUTF8AndSize(item, &slen) : NULL;
  if (!s) {
    if (!PyErr_Occurred())
      PyErr_Format(PyExc_TypeError, "CID string must be str, not %.80s",
                   Py_TYPE(item)->tp_name);
    return NULL;
  }
  if (slen == 0) {
    PyErr_SetString(PyExc_ValueError, "empty CID string");
    return NULL;
  }
  if (s[0] != 'b') {
    /* NOTE: no %c here — s is UTF-8 and a non-ASCII first byte is
     * NEGATIVE as a signed char, which makes PyErr_Format itself raise
     * OverflowError instead of the intended ValueError (found by the
     * codec fuzz soak) */
    PyErr_Format(PyExc_ValueError,
                 "unsupported multibase prefix in %R (base32 only)", item);
    return NULL;
  }
  Py_ssize_t tlen = slen - 1;
  Py_ssize_t rem = tlen % 8;
  if (rem == 1 || rem == 3 || rem == 6) {
    PyErr_Format(PyExc_ValueError, "invalid base32 length %zd", tlen);
    return NULL;
  }
  Py_ssize_t nbytes = tlen * 5 / 8;
  uint8_t buf[256];
  /* oversized CIDs (e.g. long identity-multihash digests) are valid to
   * CID.from_string — heap-allocate past the stack buffer, never reject */
  uint8_t *dec = buf;
  if ((size_t)nbytes > sizeof(buf)) {
    dec = malloc((size_t)nbytes);
    if (!dec) return PyErr_NoMemory();
  }
  uint32_t acc = 0;
  int bits = 0;
  uint8_t *w = dec;
  PyObject *cid = NULL;
  for (Py_ssize_t k = 1; k < slen; k++) {
    int8_t v = b32_val[(uint8_t)s[k]];
    if (v < 0) {
      PyErr_Format(PyExc_ValueError, "non-base32 character in %R", item);
      goto done;
    }
    acc = (acc << 5) | (uint32_t)v;
    bits += 5;
    if (bits >= 8) {
      bits -= 8;
      *w++ = (uint8_t)(acc >> bits);
    }
  }
  /* canonical check: the trailing <8 bits must be zero, or two strings
   * differing only there would decode to one CID */
  if (bits > 0 && (acc & ((1u << bits) - 1)) != 0) {
    PyErr_Format(PyExc_ValueError, "non-zero trailing bits in base32 %R", item);
    goto done;
  }
  /* detailed=1: CID.from_string surfaces from_bytes' specific messages
   * (unsupported version / truncated digest / trailing bytes), not the
   * tolerant tag-42 boundary's generic one */
  /* cid_from_raw itself rejects non-minimal varints ("non-canonical CID
   * byte encoding"), so any CID it returns is the canonical decode of
   * this string */
  cid = cid_from_raw(dec, nbytes, 1);
done:
  if (dec != buf) free(dec);
  return cid;
}

static PyObject *cid_cls_from_string(PyObject *cls, PyObject *arg) {
  (void)cls;
  return cid_from_str_item(arg);
}

static PyObject *cid_cls_parse(PyObject *cls, PyObject *arg) {
  if (PyObject_TypeCheck(arg, &CID_Type)) return Py_NewRef(arg);
  if (PyBytes_Check(arg)) return cid_cls_from_bytes(cls, arg);
  if (!PyUnicode_Check(arg)) {
    /* duck-typed CID (the pure-Python fallback class in differential
     * tests) passes through unchanged, like PurePythonCID.parse */
    int has = PyObject_HasAttr(arg, s_mh_code) && PyObject_HasAttr(arg, s_digest);
    if (has) return Py_NewRef(arg);
  }
  return cid_from_str_item(arg);
}

/* hash_of(data, codec=DAG_CBOR, mh_code=BLAKE2B_256): digest via the
 * cached hashlib constructors (scalar reference path — batch hashing
 * lives in the C++/XLA/Pallas backends) */
static PyObject *hashlib_blake2b_fn = NULL, *hashlib_sha256_fn = NULL,
                *blake2b_kwargs = NULL, *s_digest_meth = NULL;

static PyObject *cid_cls_hash_of(PyObject *cls, PyObject *args, PyObject *kwds) {
  (void)cls;
  static char *kwlist[] = {"data", "codec", "mh_code", NULL};
  Py_buffer data;
  PyObject *pcodec = NULL, *pmh = NULL;
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "y*|OO", kwlist, &data, &pcodec,
                                   &pmh))
    return NULL;
  unsigned __int128 codec = 0x71, mh = 0xB220;
  if ((pcodec && pylong_to_u128(pcodec, &codec) < 0) ||
      (pmh && pylong_to_u128(pmh, &mh) < 0)) {
    PyBuffer_Release(&data);
    return NULL;
  }
  PyObject *data_bytes = PyBytes_FromStringAndSize(data.buf, data.len);
  PyBuffer_Release(&data);
  if (!data_bytes) return NULL;
  PyObject *digest = NULL;
  if (mh == 0xB220 || mh == 0x12) {
    PyObject *one = PyTuple_Pack(1, data_bytes);
    PyObject *h =
        one ? PyObject_Call(mh == 0xB220 ? hashlib_blake2b_fn : hashlib_sha256_fn,
                            one, mh == 0xB220 ? blake2b_kwargs : NULL)
            : NULL;
    Py_XDECREF(one);
    Py_DECREF(data_bytes);
    if (!h) return NULL;
    digest = PyObject_CallMethodNoArgs(h, s_digest_meth);
    Py_DECREF(h);
    if (!digest) return NULL;
  } else if (mh == 0) { /* identity */
    digest = data_bytes;
  } else {
    Py_DECREF(data_bytes);
    PyObject *v = u128_to_pylong(mh);
    if (v) {
      PyObject *hex = PyNumber_ToBase(v, 16);
      if (hex)
        PyErr_Format(PyExc_ValueError, "unsupported multihash code %S", hex);
      Py_XDECREF(hex);
      Py_DECREF(v);
    }
    return NULL;
  }
  PyObject *out = cid_new_parts(1, codec, mh, digest);
  Py_DECREF(digest);
  return out;
}

static PyObject *cid_reduce(CIDObject *o, PyObject *ignored) {
  (void)ignored;
  PyObject *v = cid_field_pylong(o, 0);
  PyObject *c = cid_field_pylong(o, 1);
  PyObject *m = cid_field_pylong(o, 2);
  if (!v || !c || !m) {
    Py_XDECREF(v);
    Py_XDECREF(c);
    Py_XDECREF(m);
    return NULL;
  }
  return Py_BuildValue("(O(NNNO))", (PyObject *)&CID_Type, v, c, m, o->digest);
}

static PyMethodDef cid_methods_def[] = {
    {"to_bytes", (PyCFunction)cid_to_bytes_meth, METH_NOARGS,
     "Canonical binary CID encoding (varint header + digest), memoized."},
    {"from_bytes", (PyCFunction)cid_cls_from_bytes, METH_CLASS | METH_O,
     "Parse a binary CID (CIDv1 only; pure-Python CID.from_bytes parity)."},
    {"from_string", (PyCFunction)cid_cls_from_string, METH_CLASS | METH_O,
     "Parse a multibase base32-lower CID string, strictly canonical."},
    {"parse", (PyCFunction)cid_cls_parse, METH_CLASS | METH_O,
     "Coerce a CID | bytes | str into a CID."},
    {"hash_of", (PyCFunction)(void (*)(void))cid_cls_hash_of,
     METH_CLASS | METH_VARARGS | METH_KEYWORDS,
     "CID of raw block bytes (default dag-cbor / blake2b-256)."},
    {"_make", (PyCFunction)(void (*)(void))cid_cls_make,
     METH_CLASS | METH_VARARGS | METH_KEYWORDS,
     "Fast constructor alias (dataclass CID._make parity)."},
    {"__reduce__", (PyCFunction)cid_reduce, METH_NOARGS, "Pickle support."},
    {NULL, NULL, 0, NULL}};

static PyTypeObject CID_Type = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "ipc_torch_dagcbor_ext.CID",
    .tp_basicsize = sizeof(CIDObject),
    .tp_dealloc = (destructor)cid_dealloc,
    .tp_repr = (reprfunc)cid_repr,
    .tp_str = (reprfunc)cid_str_meth,
    .tp_hash = (hashfunc)cid_hash,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "Immutable CIDv1 (C-native): version, codec, mh_code, digest.",
    .tp_richcompare = cid_richcompare,
    .tp_methods = cid_methods_def,
    .tp_getset = cid_getset,
    .tp_new = cid_tp_new,
};

static int skip_item_inner(Parser *p);

static int skip_item(Parser *p) {
  if (depth_enter(p) < 0) return -1;
  int rc = skip_item_inner(p);
  p->depth--;
  return rc;
}

static int skip_item_inner(Parser *p) {
  int major;
  uint64_t value;
  int info = parse_head(p, &major, &value);
  if (info < 0) return -1;
  switch (major) {
    case 0:
    case 1:
      return 0;
    case 2:
      if ((uint64_t)(p->len - p->pos) < value) {
        PyErr_SetString(PyExc_ValueError, "truncated CBOR bytes");
        return -1;
      }
      p->pos += (Py_ssize_t)value;
      return 0;
    case 3:
      if ((uint64_t)(p->len - p->pos) < value) {
        PyErr_SetString(PyExc_ValueError, "truncated CBOR text");
        return -1;
      }
      if (!utf8_valid(p->data + p->pos, (Py_ssize_t)value)) {
        PyErr_SetString(PyExc_ValueError, "invalid UTF-8 in CBOR text");
        return -1;
      }
      p->pos += (Py_ssize_t)value;
      return 0;
    case 4:
      if ((uint64_t)p->len - p->pos < value) {
        PyErr_SetString(PyExc_ValueError, "CBOR array length exceeds input");
        return -1;
      }
      for (uint64_t i = 0; i < value; i++)
        if (skip_item(p) < 0) return -1;
      return 0;
    case 5:
      for (uint64_t i = 0; i < value; i++) {
        /* key: inner grammar errors surface first (parse_item parses the
         * key before its string-ness check), then the type check */
        Py_ssize_t key_at = p->pos;
        if (skip_item(p) < 0) return -1;
        if ((p->data[key_at] >> 5) != 3) {
          PyErr_SetString(PyExc_ValueError, "DAG-CBOR map keys must be strings");
          return -1;
        }
        if (skip_item(p) < 0) return -1;
      }
      return 0;
    case 6: {
      if (value != 42) {
        PyErr_Format(PyExc_ValueError, "unsupported CBOR tag %llu",
                     (unsigned long long)value);
        return -1;
      }
      Py_ssize_t inner_at = p->pos;
      int imajor;
      uint64_t ival;
      if (parse_head(p, &imajor, &ival) < 0) return -1;
      if (imajor != 2) {
        /* parse the non-bytes item for error ordering, then reject */
        p->pos = inner_at;
        if (skip_item(p) < 0) return -1;
        PyErr_SetString(PyExc_ValueError,
                        "tag-42 content must be identity-multibase CID bytes");
        return -1;
      }
      if ((uint64_t)(p->len - p->pos) < ival) {
        PyErr_SetString(PyExc_ValueError, "truncated CBOR bytes");
        return -1;
      }
      const uint8_t *content = p->data + p->pos;
      p->pos += (Py_ssize_t)ival;
      if (ival < 1 || content[0] != 0) {
        PyErr_SetString(PyExc_ValueError,
                        "tag-42 content must be identity-multibase CID bytes");
        return -1;
      }
      if (!cid_bytes_valid(content + 1, (Py_ssize_t)ival - 1)) {
        PyErr_SetString(PyExc_ValueError, "malformed CID bytes in tag 42");
        return -1;
      }
      return 0;
    }
    case 7:
      if (info == 27 || value == 20 || value == 21 || value == 22) return 0;
      PyErr_Format(PyExc_ValueError, "unsupported CBOR simple value %llu",
                   (unsigned long long)value);
      return -1;
  }
  PyErr_SetString(PyExc_ValueError, "unreachable CBOR major type");
  return -1;
}

/* Header fields verification reads (BlockHeader.decode's named fields):
 * 5 parents, 6 parent_weight, 7 height, 8 parent_state_root,
 * 9 parent_message_receipts, 10 messages, 12 timestamp, 14 fork_signaling.
 * The rest are validated (skip_item) but returned as None. */
static const char header_keep[16] = {0, 0, 0, 0, 0, 1, 1, 1,
                                     1, 1, 1, 0, 1, 0, 1, 0};

/* decode_header_lite(raw) -> (parents, height, parent_state_root,
 * parent_message_receipts, messages): the five fields verification reads,
 * with state/header.py's _validate_core_fields folded in. Acceptance is
 * EXACTLY decode_header + the Python validation: the full grammar is
 * walked first (so a later field's grammar error outranks a type
 * error, as in the Python ordering), then the kept fields type-check. */
static const char header_lite_keep[16] = {0, 0, 0, 0, 0, 1, 0, 1,
                                          1, 1, 1, 0, 0, 0, 0, 0};

static PyObject *py_decode_header_lite(PyObject *self, PyObject *arg) {
  (void)self;
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
  Parser p = {(const uint8_t *)view.buf, view.len, 0, 0};
  PyObject *kept[16] = {0};
  PyObject *result = NULL;
  int major;
  uint64_t value;
  int info = parse_head(&p, &major, &value);
  if (info < 0) goto done;
  if (major != 4 || value != 16) {
    Parser q = {(const uint8_t *)view.buf, view.len, 0, 0};
    if (skip_item(&q) < 0) goto done;
    if (q.pos != q.len) {
      PyErr_Format(PyExc_ValueError, "trailing bytes after CBOR item (%zd bytes)",
                   (Py_ssize_t)(q.len - q.pos));
      goto done;
    }
    PyErr_SetString(PyExc_ValueError, "block header is not a 16-tuple");
    goto done;
  }
  if ((uint64_t)view.len - p.pos < value) {
    PyErr_SetString(PyExc_ValueError, "CBOR array length exceeds input");
    goto done;
  }
  p.depth = 1; /* outer array consumed via parse_head (see decode_header) */
  for (int i = 0; i < 16; i++) {
    if (header_lite_keep[i]) {
      kept[i] = parse_item(&p);
      if (!kept[i]) goto done;
    } else if (skip_item(&p) < 0) {
      goto done;
    }
  }
  if (p.pos != p.len) {
    PyErr_Format(PyExc_ValueError, "trailing bytes after CBOR item (%zd bytes)",
                 (Py_ssize_t)(p.len - p.pos));
    goto done;
  }
  /* _validate_core_fields parity (same messages, same order) */
  if (!PyList_Check(kept[5])) {
    PyErr_SetString(PyExc_ValueError, "header parents must be a CID list");
    goto done;
  }
  for (Py_ssize_t i = 0; i < PyList_GET_SIZE(kept[5]); i++) {
    if (!PyObject_TypeCheck(PyList_GET_ITEM(kept[5], i), &CID_Type)) {
      PyErr_SetString(PyExc_ValueError, "header parents must be a CID list");
      goto done;
    }
  }
  {
    static const int idxs[3] = {8, 9, 10};
    static const char *names[3] = {"parent_state_root",
                                   "parent_message_receipts", "messages"};
    for (int k = 0; k < 3; k++) {
      if (!PyObject_TypeCheck(kept[idxs[k]], &CID_Type)) {
        PyErr_Format(PyExc_ValueError, "header field %s must be a CID",
                     names[k]);
        goto done;
      }
    }
  }
  result = PyTuple_Pack(5, kept[5], kept[7], kept[8], kept[9], kept[10]);
done:
  for (int i = 0; i < 16; i++) Py_XDECREF(kept[i]);
  PyBuffer_Release(&view);
  return result;
}

static PyObject *py_decode_header(PyObject *self, PyObject *arg) {
  (void)self;
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
  Parser p = {(const uint8_t *)view.buf, view.len, 0, 0};
  PyObject *result = NULL;
  int major;
  uint64_t value;
  int info = parse_head(&p, &major, &value);
  if (info < 0) goto done;
  if (major != 4 || value != 16) {
    /* match BlockHeader.decode over the full decoder: grammar errors (and
     * trailing-bytes errors) surface first, then the shape rejection */
    Parser q = {(const uint8_t *)view.buf, view.len, 0, 0};
    if (skip_item(&q) < 0) goto done;
    if (q.pos != q.len) {
      PyErr_Format(PyExc_ValueError, "trailing bytes after CBOR item (%zd bytes)",
                   (Py_ssize_t)(q.len - q.pos));
      goto done;
    }
    PyErr_SetString(PyExc_ValueError, "block header is not a 16-tuple");
    goto done;
  }
  if ((uint64_t)view.len - p.pos < value) {
    PyErr_SetString(PyExc_ValueError, "CBOR array length exceeds input");
    goto done;
  }
  /* the outer 16-array was consumed via parse_head above, bypassing
   * depth_enter — account for it so fields nest at the same depth they
   * would under parse_item (acceptance parity with the full decode) */
  p.depth = 1;
  result = PyList_New(16);
  if (!result) goto done;
  for (int i = 0; i < 16; i++) {
    PyObject *item;
    if (header_keep[i]) {
      item = parse_item(&p);
    } else {
      item = skip_item(&p) < 0 ? NULL : Py_NewRef(Py_None);
    }
    if (!item) {
      Py_DECREF(result);
      result = NULL;
      goto done;
    }
    PyList_SET_ITEM(result, i, item);
  }
  if (p.pos != p.len) {
    Py_DECREF(result);
    result = NULL;
    PyErr_Format(PyExc_ValueError, "trailing bytes after CBOR item (%zd bytes)",
                 (Py_ssize_t)(p.len - p.pos));
  }
done:
  PyBuffer_Release(&view);
  return result;
}

static PyObject *py_decode(PyObject *self, PyObject *arg) {
  (void)self;
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
  Parser p = {(const uint8_t *)view.buf, view.len, 0, 0};
  PyObject *result = parse_item(&p);
  if (result && p.pos != p.len) {
    Py_DECREF(result);
    result = NULL;
    PyErr_Format(PyExc_ValueError, "trailing bytes after CBOR item (%zd bytes)",
                 (Py_ssize_t)(p.len - p.pos));
  }
  PyBuffer_Release(&view);
  return result;
}

static PyObject *py_decode_many(PyObject *self, PyObject *arg) {
  PyObject *seq = PySequence_Fast(arg, "decode_many expects a sequence");
  if (!seq) return NULL;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  PyObject *out = PyList_New(n);
  if (!out) {
    Py_DECREF(seq);
    return NULL;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *item = py_decode(self, PySequence_Fast_GET_ITEM(seq, i));
    if (!item) {
      Py_DECREF(out);
      Py_DECREF(seq);
      return NULL;
    }
    PyList_SET_ITEM(out, i, item);
  }
  Py_DECREF(seq);
  return out;
}

static PyObject *py_set_cid_factory(PyObject *self, PyObject *arg) {
  (void)self;
  if (!PyCallable_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "CID factory must be callable");
    return NULL;
  }
  Py_XDECREF(cid_factory);
  Py_INCREF(arg);
  cid_factory = arg;
  Py_RETURN_NONE;
}

/* make_cids(list[bytes]) -> list[CID]: batch C-side construction for the
 * witness-materialization paths (thousands of CIDs per range bundle). */
static PyObject *py_make_cids(PyObject *self, PyObject *arg) {
  (void)self;
  PyObject *seq = PySequence_Fast(arg, "make_cids expects a sequence of bytes");
  if (!seq) return NULL;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  PyObject *out = PyList_New(n);
  if (!out) {
    Py_DECREF(seq);
    return NULL;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
    if (!PyBytes_Check(item)) {
      Py_DECREF(out);
      Py_DECREF(seq);
      PyErr_SetString(PyExc_TypeError, "make_cids expects bytes items");
      return NULL;
    }
    PyObject *cid = make_cid((const uint8_t *)PyBytes_AS_STRING(item),
                             PyBytes_GET_SIZE(item));
    if (!cid) {
      Py_DECREF(out);
      Py_DECREF(seq);
      return NULL;
    }
    PyList_SET_ITEM(out, i, cid);
  }
  Py_DECREF(seq);
  return out;
}

/* cid_strs(list[bytes]) -> list[str]: batch multibase base32-lower
 * rendering ("b" prefix, RFC 4648 lower alphabet, no padding) — exactly
 * CID.__str__'s output for raw CID bytes. Claim construction renders one
 * string per proof plus two per pair; the Python int-codec costs ~6 µs
 * per CID where this is ~100 ns. */
static const char b32_alpha[32] = "abcdefghijklmnopqrstuvwxyz234567";

static PyObject *py_cid_strs(PyObject *self, PyObject *arg) {
  (void)self;
  PyObject *seq = PySequence_Fast(arg, "cid_strs expects a sequence of bytes");
  if (!seq) return NULL;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  PyObject *out = PyList_New(n);
  if (!out) {
    Py_DECREF(seq);
    return NULL;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
    if (!PyBytes_Check(item)) {
      Py_DECREF(out);
      Py_DECREF(seq);
      PyErr_SetString(PyExc_TypeError, "cid_strs expects bytes items");
      return NULL;
    }
    PyObject *str = b32_render((const uint8_t *)PyBytes_AS_STRING(item),
                               PyBytes_GET_SIZE(item));
    if (!str) {
      Py_DECREF(out);
      Py_DECREF(seq);
      return NULL;
    }
    PyList_SET_ITEM(out, i, str);
  }
  Py_DECREF(seq);
  return out;
}

/* cids_from_strs(list[str]) -> list[CID]: batch multibase base32 parse +
 * CID construction — CID.from_string semantics exactly: 'b' prefix
 * required, unpadded length classes {1,3,6} (mod 8) rejected, and STRICT
 * canonical decoding — lowercase only (multibase 'b' is base32-lower)
 * and non-zero trailing sub-byte bits rejected, matching the reference
 * multibase stack and the Python codec: every accepted string is the
 * unique canonical form of its bytes, so no two strings alias one CID.
 * Then CID.from_bytes validation via make_cid. */
static int8_t b32_val[256];
static int b32_val_ready = 0;

static void b32_val_init(void) {
  memset(b32_val, -1, sizeof(b32_val));
  for (int i = 0; i < 32; i++) {
    b32_val[(uint8_t)b32_alpha[i]] = (int8_t)i; /* lowercase only */
  }
  b32_val_ready = 1;
}

static PyObject *py_cids_from_strs(PyObject *self, PyObject *arg) {
  (void)self;
  PyObject *seq = PySequence_Fast(arg, "cids_from_strs expects a sequence of str");
  if (!seq) return NULL;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  PyObject *out = PyList_New(n);
  if (!out) {
    Py_DECREF(seq);
    return NULL;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *cid = cid_from_str_item(PySequence_Fast_GET_ITEM(seq, i));
    if (!cid) {
      Py_DECREF(out);
      Py_DECREF(seq);
      return NULL;
    }
    PyList_SET_ITEM(out, i, cid);
  }
  Py_DECREF(seq);
  return out;
}

static PyObject *py_set_cid_class(PyObject *self, PyObject *arg) {
  (void)self;
  if (!PyType_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "CID class must be a type");
    return NULL;
  }
  Py_XDECREF(cid_class);
  Py_INCREF(arg);
  cid_class = arg;
  Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"decode", py_decode, METH_O, "Decode one DAG-CBOR item from bytes."},
    {"decode_many", py_decode_many, METH_O,
     "Decode a sequence of DAG-CBOR byte strings."},
    {"decode_header", py_decode_header, METH_O,
     "Decode a 16-field block header, materializing only the fields "
     "verification reads (others validated and returned as None)."},
    {"decode_header_lite", py_decode_header_lite, METH_O,
     "decode_header(raw) narrowed to (parents, height, parent_state_root, "
     "parent_message_receipts, messages) with the core-field type "
     "validation folded in (state/header.py LiteHeader parity)."},
    {"set_cid_factory", py_set_cid_factory, METH_O,
     "Register callable(bytes)->CID used for tag-42 links when no CID "
     "class is registered (set_cid_class takes precedence)."},
    {"set_cid_class", py_set_cid_class, METH_O,
     "Register the CID class for direct C-side construction of tag-42 "
     "links (bypasses the per-link Python factory call)."},
    {"make_cids", py_make_cids, METH_O,
     "Construct a list of CID objects from raw CID byte strings in one "
     "call (from_bytes semantics)."},
    {"cid_strs", py_cid_strs, METH_O,
     "Render raw CID bytes as multibase base32-lower strings ('b' prefix, "
     "no padding) in one call (CID.__str__ semantics)."},
    {"cids_from_strs", py_cids_from_strs, METH_O,
     "Parse multibase base32 CID strings into CID objects in one call "
     "(CID.from_string semantics)."},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "ipc_torch_dagcbor_ext",
                                       "Fast DAG-CBOR decoder", -1, methods,
                                       NULL, NULL, NULL, NULL};

PyMODINIT_FUNC PyInit_ipc_torch_dagcbor_ext(void) {
  s_version = PyUnicode_InternFromString("version");
  s_codec = PyUnicode_InternFromString("codec");
  s_mh_code = PyUnicode_InternFromString("mh_code");
  s_digest = PyUnicode_InternFromString("digest");
  s_bytes = PyUnicode_InternFromString("_bytes");
  s_digest_meth = PyUnicode_InternFromString("digest");
  if (!s_version || !s_codec || !s_mh_code || !s_digest || !s_bytes ||
      !s_digest_meth)
    return NULL;
  /* hash_of digest backends: cached hashlib constructors */
  PyObject *hashlib = PyImport_ImportModule("hashlib");
  if (!hashlib) return NULL;
  hashlib_blake2b_fn = PyObject_GetAttrString(hashlib, "blake2b");
  hashlib_sha256_fn = PyObject_GetAttrString(hashlib, "sha256");
  Py_DECREF(hashlib);
  blake2b_kwargs = Py_BuildValue("{s:i}", "digest_size", 32);
  if (!hashlib_blake2b_fn || !hashlib_sha256_fn || !blake2b_kwargs) return NULL;
  if (PyType_Ready(&CID_Type) < 0) return NULL;
  PyObject *m = PyModule_Create(&moduledef);
  if (!m) return NULL;
  Py_INCREF(&CID_Type);
  if (PyModule_AddObject(m, "CID", (PyObject *)&CID_Type) < 0) {
    Py_DECREF(&CID_Type);
    Py_DECREF(m);
    return NULL;
  }
  return m;
}
