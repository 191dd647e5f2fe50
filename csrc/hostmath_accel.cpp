// Native host-side number theory for bgn_jax key generation.
//
// This plays the role of PBC's C parameter generator
// for the reference (pbc_param_init_a1_gen / GenerateA1, used at
// reference bgn.go:93): the cofactor search "find the smallest l = 4k with
// p = l*n - 1 prime" is the hot loop of keygen, and primality testing
// dominates it.  Implemented as a fixed-width bignum (64-bit limbs,
// Montgomery modexp, Miller-Rabin) plus an incremental small-prime sieve
// over the l progression so almost all candidates are rejected without a
// single bignum multiplication.
//
// Exposed as a tiny extern "C" byte-array API consumed via ctypes
// (bgn_jax/utils/native.py), with a pure-Python fallback
// (hostmath.find_cofactor) when the shared object is absent.
//
// Built at first use, or by `make native` (produces build/libbgnhost.so).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using u64 = std::uint64_t;
using u128 = unsigned __int128;

constexpr int MAX_LIMBS = 72;  // up to 4608 bits

struct Big {
  u64 w[MAX_LIMBS];
  int n;  // limbs in use (normalized: w[n-1] != 0 unless n == 0)

  void norm() {
    while (n > 0 && w[n - 1] == 0) --n;
  }
};

void big_zero(Big &a) {
  std::memset(a.w, 0, sizeof(a.w));
  a.n = 0;
}

void big_from_bytes(Big &a, const unsigned char *le, int nbytes) {
  big_zero(a);
  for (int i = 0; i < nbytes; ++i)
    a.w[i / 8] |= (u64)le[i] << (8 * (i % 8));
  a.n = (nbytes + 7) / 8;
  a.norm();
}

void big_to_bytes(const Big &a, unsigned char *le, int nbytes) {
  std::memset(le, 0, nbytes);
  for (int i = 0; i < nbytes && i < a.n * 8; ++i)
    le[i] = (unsigned char)(a.w[i / 8] >> (8 * (i % 8)));
}

int big_cmp(const Big &a, const Big &b) {
  if (a.n != b.n) return a.n < b.n ? -1 : 1;
  for (int i = a.n - 1; i >= 0; --i)
    if (a.w[i] != b.w[i]) return a.w[i] < b.w[i] ? -1 : 1;
  return 0;
}

// a += b
void big_add(Big &a, const Big &b) {
  u64 carry = 0;
  int n = a.n > b.n ? a.n : b.n;
  for (int i = 0; i < n; ++i) {
    u128 s = (u128)a.w[i] + (i < b.n ? b.w[i] : 0) + carry;
    a.w[i] = (u64)s;
    carry = (u64)(s >> 64);
  }
  a.n = n;
  if (carry) a.w[a.n++] = carry;
}

// a -= b (requires a >= b)
void big_sub(Big &a, const Big &b) {
  u64 borrow = 0;
  for (int i = 0; i < a.n; ++i) {
    u64 bw = i < b.n ? b.w[i] : 0;
    u128 need = (u128)bw + borrow;
    if ((u128)a.w[i] >= need) {
      a.w[i] = (u64)((u128)a.w[i] - need);
      borrow = 0;
    } else {
      a.w[i] = (u64)((((u128)1 << 64) | a.w[i]) - need);
      borrow = 1;
    }
  }
  a.norm();
}

// a = b * small + delta (small fits u64; delta signed small)
void big_mul_small(Big &out, const Big &b, u64 small) {
  u64 carry = 0;
  for (int i = 0; i < b.n; ++i) {
    u128 pdt = (u128)b.w[i] * small + carry;
    out.w[i] = (u64)pdt;
    carry = (u64)(pdt >> 64);
  }
  out.n = b.n;
  if (carry) out.w[out.n++] = carry;
  for (int i = out.n; i < MAX_LIMBS; ++i) out.w[i] = 0;
}

// a = a - 1 (a > 0)
void big_dec(Big &a) {
  int i = 0;
  while (a.w[i] == 0) a.w[i++] = ~0ULL;
  a.w[i] -= 1;
  a.norm();
}

u64 big_mod_small(const Big &a, u64 m) {
  u128 r = 0;
  for (int i = a.n - 1; i >= 0; --i) r = ((r << 64) | a.w[i]) % m;
  return (u64)r;
}

// ---- Montgomery arithmetic modulo odd p ----

struct Mont {
  Big p;
  int k;        // limbs of p
  u64 pinv;     // -p^-1 mod 2^64
  Big r2;       // R^2 mod p, R = 2^(64k)
  Big one;      // R mod p
};

u64 inv64(u64 a) {  // a odd; Newton iteration for a^-1 mod 2^64
  u64 x = a;
  for (int i = 0; i < 5; ++i) x *= 2 - a * x;
  return x;
}

// out = mont_mul(a, b) = a*b*R^-1 mod p  (CIOS)
void mont_mul(const Mont &m, const Big &a, const Big &b, Big &out) {
  int k = m.k;
  u64 t[MAX_LIMBS + 2];
  std::memset(t, 0, sizeof(u64) * (k + 2));
  for (int i = 0; i < k; ++i) {
    u64 ai = i < a.n ? a.w[i] : 0;
    u64 carry = 0;
    for (int j = 0; j < k; ++j) {
      u128 s = (u128)t[j] + (u128)ai * (j < b.n ? b.w[j] : 0) + carry;
      t[j] = (u64)s;
      carry = (u64)(s >> 64);
    }
    u128 s = (u128)t[k] + carry;
    t[k] = (u64)s;
    t[k + 1] = (u64)(s >> 64);

    u64 mi = t[0] * m.pinv;
    carry = 0;
    for (int j = 0; j < k; ++j) {
      u128 s2 = (u128)t[j] + (u128)mi * m.p.w[j] + carry;
      t[j] = (u64)s2;
      carry = (u64)(s2 >> 64);
    }
    s = (u128)t[k] + carry;
    t[k] = (u64)s;
    t[k + 1] += (u64)(s >> 64);
    for (int j = 0; j <= k; ++j) t[j] = t[j + 1];
    t[k + 1] = 0;
  }
  out.n = k + 1;
  for (int j = 0; j <= k; ++j) out.w[j] = t[j];
  for (int j = k + 1; j < MAX_LIMBS; ++j) out.w[j] = 0;
  out.norm();
  if (big_cmp(out, m.p) >= 0) big_sub(out, m.p);
}

void mont_setup(Mont &m, const Big &p) {
  m.p = p;
  m.k = p.n;
  m.pinv = (u64)(0 - inv64(p.w[0]));
  // one = R mod p by shifting 1 left 64k bits with conditional subtract
  Big r;
  big_zero(r);
  r.w[0] = 1;
  r.n = 1;
  for (int bit = 0; bit < 64 * m.k; ++bit) {
    big_add(r, r);  // double
    if (big_cmp(r, p) >= 0) big_sub(r, p);
  }
  m.one = r;
  // r2 = R^2 mod p: keep doubling another 64k times
  for (int bit = 0; bit < 64 * m.k; ++bit) {
    big_add(r, r);
    if (big_cmp(r, p) >= 0) big_sub(r, p);
  }
  m.r2 = r;
}

// out = base^e mod p (base in normal domain)
void mont_pow(const Mont &m, const Big &base, const Big &e, Big &out) {
  Big b;
  mont_mul(m, base, m.r2, b);  // to Montgomery
  Big acc = m.one;
  for (int i = e.n - 1; i >= 0; --i) {
    for (int bit = 63; bit >= 0; --bit) {
      Big t;
      mont_mul(m, acc, acc, t);
      acc = t;
      if ((e.w[i] >> bit) & 1) {
        mont_mul(m, acc, b, t);
        acc = t;
      }
    }
  }
  Big onev;
  big_zero(onev);
  onev.w[0] = 1;
  onev.n = 1;
  mont_mul(m, acc, onev, out);  // from Montgomery
}

// ---- Miller-Rabin ----

u64 rng_state = 0x9E3779B97F4A7C15ULL;
u64 xorshift() {
  rng_state ^= rng_state << 13;
  rng_state ^= rng_state >> 7;
  rng_state ^= rng_state << 17;
  return rng_state;
}

bool miller_rabin(const Big &p, int rounds) {
  // p odd, > 3
  Big d = p;
  big_dec(d);  // p - 1
  int r = 0;
  while ((d.w[0] & 1) == 0) {
    // d >>= 1
    for (int i = 0; i < d.n; ++i) {
      d.w[i] >>= 1;
      if (i + 1 < d.n) d.w[i] |= d.w[i + 1] << 63;
    }
    d.norm();
    ++r;
  }
  Mont m;
  mont_setup(m, p);
  Big pm1 = p;
  big_dec(pm1);
  for (int it = 0; it < rounds; ++it) {
    // random base 2 <= a < p: sample p.n-1 full words + top word reduced
    // strictly below p's top word (so a < p by construction)
    Big a;
    big_zero(a);
    for (int i = 0; i < p.n - 1; ++i) a.w[i] = xorshift();
    if (p.w[p.n - 1] > 1)
      a.w[p.n - 1] = xorshift() % p.w[p.n - 1];
    a.n = p.n;
    a.norm();
    if (a.n == 0 || (a.n == 1 && a.w[0] < 2)) {
      big_zero(a);
      a.w[0] = 2;
      a.n = 1;
    }
    Big x;
    mont_pow(m, a, d, x);
    if ((x.n == 1 && x.w[0] == 1) || big_cmp(x, pm1) == 0) continue;
    bool witness = true;
    for (int j = 0; j < r - 1; ++j) {
      Big t;
      mont_mul(m, x, m.r2, t);  // to Montgomery
      Big t2;
      mont_mul(m, t, t, t2);    // t2 = x^2 * R
      Big onev;
      big_zero(onev);
      onev.w[0] = 1;
      onev.n = 1;
      mont_mul(m, t2, onev, x);  // back to normal domain
      if (big_cmp(x, pm1) == 0) {
        witness = false;
        break;
      }
      if (x.n == 1 && x.w[0] == 1) break;  // nontrivial sqrt of 1
    }
    if (witness) return false;
  }
  return true;
}

std::vector<u64> small_primes_upto(u64 bound) {
  std::vector<bool> comp(bound + 1, false);
  std::vector<u64> out;
  for (u64 i = 2; i <= bound; ++i) {
    if (!comp[i]) {
      out.push_back(i);
      for (u64 j = i * i; j <= bound; j += i) comp[j] = true;
    }
  }
  return out;
}

}  // namespace

extern "C" {

// Probabilistic primality of the little-endian nbytes number. 1 = probable
// prime, 0 = composite, -1 = bad input.
int bgn_is_probable_prime(const unsigned char *le, int nbytes, int rounds) {
  if (nbytes <= 0 || nbytes > MAX_LIMBS * 8) return -1;
  Big p;
  big_from_bytes(p, le, nbytes);
  if (p.n == 0) return 0;
  if (p.n == 1 && p.w[0] < 4) return p.w[0] >= 2;
  if ((p.w[0] & 1) == 0) return 0;
  static std::vector<u64> primes = small_primes_upto(10000);
  for (u64 sp : primes) {
    if (big_mod_small(p, sp) == 0)
      return (p.n == 1 && p.w[0] == sp) ? 1 : 0;
  }
  return miller_rabin(p, rounds) ? 1 : 0;
}

// Find the smallest l = start_l + 4k (k >= 0) such that p = l*n - 1 is
// probably prime (the PBC a1 cofactor search).  n is little-endian.
// Returns l, or 0 on failure/bad input.  max_l bounds the search.
unsigned long long bgn_find_cofactor(const unsigned char *n_le, int nbytes,
                                     unsigned long long start_l,
                                     unsigned long long max_l, int rounds) {
  if (nbytes <= 0 || nbytes > (MAX_LIMBS - 2) * 8) return 0;
  Big n;
  big_from_bytes(n, n_le, nbytes);
  if (n.n == 0) return 0;
  static std::vector<u64> primes = small_primes_upto(100000);
  // residues: n mod sp for incremental screening of p = l*n - 1
  std::vector<u64> nmod(primes.size());
  for (size_t i = 0; i < primes.size(); ++i)
    nmod[i] = big_mod_small(n, primes[i]);
  for (unsigned long long l = start_l; l <= max_l; l += 4) {
    bool composite = false;
    for (size_t i = 0; i < primes.size(); ++i) {
      u64 sp = primes[i];
      u64 r = ((u128)(l % sp) * nmod[i] + sp - 1) % sp;
      if (r == 0) {
        // p divisible by sp; p == sp impossible at our sizes
        composite = true;
        break;
      }
    }
    if (composite) continue;
    Big p;
    big_mul_small(p, n, l);
    big_dec(p);
    if (miller_rabin(p, rounds)) return l;
  }
  return 0;
}

}  // extern "C"
