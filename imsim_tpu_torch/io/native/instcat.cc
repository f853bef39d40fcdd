// phoSim instance-catalog tokenizer — the native data-loader for the
// catalog ingest path (imsim/instcat.py:115-160 reads the same format
// through Python line loops; at DC2 scale a visit catalog is millions
// of `object` lines, and tokenizing them dominates host-side visit
// setup).  One pass over an in-memory buffer: numeric fields are
// parsed with strtod into a row-major double matrix, string fields
// (id, sed, token12) are returned as (offset, length) pairs into the
// caller's buffer.  Semantics mirror catalog/instcat.py::_parse_instcat
// exactly (tests/test_torch_native_instcat.py holds the two equal):
//   * lines containing " inf " are skipped
//   * magnorm >= 50 and malformed sersic/knots rows are skipped when
//     skip_invalid is set
//   * reduced shear g = gamma/(1-kappa), mu = 1/((1-kappa)^2 - gamma^2)
//   * beta = (90 -/+ pa) deg depending on flip_g2
//   * dust blocks with 'none'/'CCM' markers at the per-type offset
//
// Build: g++ -O3 -shared -fPIC instcat.cc (catalog/native_instcat.py
// builds it at first use into imsim_tpu_torch/_build/, named by a hash
// of this source).
#include <cmath>
#include <cstdlib>
#include <cstring>

namespace {

constexpr double DEG = 0.017453292519943295;
constexpr int NUMF = 15;  // ra dec magnorm redshift g1 g2 mu p0..p3 iav irv gav grv
constexpr int MAXTOK = 64;

enum Code { POINT = 0, SERSIC = 1, KNOTS = 2, STREAK = 3, FITSIMAGE = 4 };

struct Tok {
  const char* p;
  long n;
};

inline double tod(const Tok& t) {
  // tokens sit inside the caller's buffer followed by whitespace (or
  // the terminating NUL of a CPython bytes object), so strtod can
  // parse in place — it stops at the first non-numeric character
  return std::strtod(t.p, nullptr);
}

// type-name compares are case-insensitive: the Python parser lowers
// tokens[12] before dispatch
inline bool eq(const Tok& t, const char* s) {
  long n = (long)std::strlen(s);
  if (t.n != n) return false;
  for (long k = 0; k < n; ++k)
    if ((t.p[k] | 32) != s[k]) return false;
  return true;
}

inline bool ends_with(const Tok& t, const char* s) {
  long n = (long)std::strlen(s);
  if (t.n < n) return false;
  for (long k = 0; k < n; ++k)
    if ((t.p[t.n - n + k] | 32) != s[k]) return false;
  return true;
}

inline bool is_none(const Tok& t) {  // 'none' case-insensitive
  if (t.n != 4) return false;
  return (t.p[0] | 32) == 'n' && (t.p[1] | 32) == 'o' &&
         (t.p[2] | 32) == 'n' && (t.p[3] | 32) == 'e';
}

}  // namespace

extern "C" {

// Returns number of parsed objects, or -(byte offset)-1 of an
// unknown-type line.  Caller sizes outputs with cap >= count of
// 'object' lines (io/native/rice.cc::instcat_scan).  ntot_out gets the count
// of non-skipped 'object' lines seen (the parse log denominator).
long instcat_parse(const char* buf, long n, double* num, int* type_code,
                   long* str_off, long* str_len,  // (cap, 3): id, sed, tok12
                   long cap, int flip_g2, int skip_invalid,
                   long* ntot_out) {
  long count = 0, ntot = 0;
  const double g2s = flip_g2 ? -1.0 : 1.0;
  long i = 0;
  while (i < n) {
    long eol = i;
    while (eol < n && buf[eol] != '\n') ++eol;
    // "object " prefix?
    if (eol - i > 7 && std::memcmp(buf + i, "object", 6) == 0 &&
        (buf[i + 6] == ' ' || buf[i + 6] == '\t')) {
      // " inf " anywhere in the line -> skip (instcat.py sentinel)
      bool has_inf = false;
      for (long k = i; k + 5 <= eol; ++k) {
        if (buf[k] == ' ' && buf[k + 1] == 'i' && buf[k + 2] == 'n' &&
            buf[k + 3] == 'f' && buf[k + 4] == ' ') {
          has_inf = true;
          break;
        }
      }
      if (!has_inf) {
        ++ntot;
        // tokenize
        Tok tok[MAXTOK];
        int nt = 0;
        long k = i;
        while (k < eol && nt < MAXTOK) {
          while (k < eol && (buf[k] == ' ' || buf[k] == '\t' ||
                             buf[k] == '\r'))
            ++k;
          if (k >= eol) break;
          long s = k;
          while (k < eol && buf[k] != ' ' && buf[k] != '\t' &&
                 buf[k] != '\r')
            ++k;
          tok[nt].p = buf + s;
          tok[nt].n = k - s;
          ++nt;
        }
        if (nt < 13) { i = eol + 1; continue; }
        double magnorm = tod(tok[4]);
        double gamma1 = tod(tok[7]);
        double gamma2 = g2s * tod(tok[8]);
        double kappa = tod(tok[9]);
        const Tok& t12 = tok[12];
        int code;
        int dust_index = 15;
        double p[4] = {0, 0, 0, 0};
        bool ok = !(skip_invalid && magnorm >= 50.0);
        if (eq(t12, "point")) {
          code = POINT;
          dust_index = 13;
        } else if (eq(t12, "sersic2d")) {
          code = SERSIC;
          dust_index = 17;
          if (nt < 17) { i = eol + 1; continue; }
          double a = tod(tok[13]), b = tod(tok[14]), pa = tod(tok[15]);
          double beta = (flip_g2 ? 90.0 - pa : 90.0 + pa) * DEG;
          double ns = std::round(tod(tok[16]) * 20.0) / 20.0;
          p[0] = std::sqrt(a * b); p[1] = ns; p[2] = b / a; p[3] = beta;
          if (skip_invalid && a < b) ok = false;
        } else if (eq(t12, "knots")) {
          code = KNOTS;
          dust_index = 17;
          if (nt < 17) { i = eol + 1; continue; }
          double a = tod(tok[13]), b = tod(tok[14]), pa = tod(tok[15]);
          double beta = (flip_g2 ? 90.0 - pa : 90.0 + pa) * DEG;
          long npoints = (long)tod(tok[16]);
          p[0] = std::sqrt(a * b); p[1] = (double)npoints;
          p[2] = b / a; p[3] = beta;
          if (skip_invalid && (a < b || npoints <= 0)) ok = false;
        } else if (eq(t12, "streak")) {
          code = STREAK;
          dust_index = 16;
          if (nt < 16) { i = eol + 1; continue; }
          p[0] = tod(tok[13]); p[1] = tod(tok[14]);
          p[2] = tod(tok[15]) * DEG; p[3] = 0.0;
        } else if (ends_with(t12, ".fits") || ends_with(t12, ".fits.gz")) {
          code = FITSIMAGE;
          dust_index = 15;
          if (nt < 15) { i = eol + 1; continue; }
          p[0] = tod(tok[13]); p[1] = tod(tok[14]) * DEG;
        } else {
          return -(i) - 1;  // unknown type at byte offset i
        }
        if (ok && count < cap) {
          // dust: [internal] [mw], 'none' markers collapse a block
          double iav = 0.0, irv = 3.1, gav = 0.0, grv = 3.1;
          int d = dust_index;
          if (d < nt) {
            if (!is_none(tok[d])) {
              if (d + 2 < nt) { iav = tod(tok[d + 1]); irv = tod(tok[d + 2]); }
              d += 3;
            } else {
              d += 1;
            }
            if (d < nt && !is_none(tok[d]) && d + 2 < nt) {
              gav = tod(tok[d + 1]);
              grv = tod(tok[d + 2]);
            }
          }
          double om = 1.0 - kappa;
          double* row = num + count * NUMF;
          row[0] = tod(tok[2]) * DEG;              // ra
          row[1] = tod(tok[3]) * DEG;              // dec
          row[2] = magnorm;
          row[3] = tod(tok[6]);                    // redshift
          row[4] = gamma1 / om;                    // g1 reduced
          row[5] = gamma2 / om;                    // g2 reduced
          row[6] = 1.0 / (om * om - (gamma1 * gamma1 + gamma2 * gamma2));
          row[7] = p[0]; row[8] = p[1]; row[9] = p[2]; row[10] = p[3];
          row[11] = iav; row[12] = irv; row[13] = gav; row[14] = grv;
          type_code[count] = code;
          str_off[count * 3 + 0] = tok[1].p - buf;
          str_len[count * 3 + 0] = tok[1].n;
          str_off[count * 3 + 1] = tok[5].p - buf;
          str_len[count * 3 + 1] = tok[5].n;
          str_off[count * 3 + 2] = t12.p - buf;
          str_len[count * 3 + 2] = t12.n;
          ++count;
        }
      }
    }
    i = eol + 1;
  }
  *ntot_out = ntot;
  return count;
}

}  // extern "C"
